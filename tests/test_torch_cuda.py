"""The twenty-four CUDA kernels (and the int8 page write, a second entry of
``absmax_quant_rows``) against their plain PyTorch versions on the card, and
the two random-gather yardsticks (``kernels/yardstick.py``) against theirs.

Marked ``cuda``; each test skips with a reason where torch sees no CUDA
device (the kernels have no CPU or interpret mode). On a machine with an
NVIDIA GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX: the card's machine runs the port alone.
"""

import numpy as np
import pytest
import torch

from _torch_parity import ordered_scatter_mean
from repro_torch import kernels
from repro_torch.kernels import epilogue, paged, permk, quantize, randk, ref

pytestmark = pytest.mark.cuda

SHAPES = [(4, 37, 1024, 20), (3, 11, 256, 128), (1, 5, 128, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ulp(a, b) -> int:
    bits, top = (torch.int32, 2**31) if a.dtype == torch.float32 else (torch.int16, 2**15)
    ia, ib = a.view(bits).long(), b.view(bits).long()
    ka = torch.where(ia < 0, -top - ia, ia)
    kb = torch.where(ib < 0, -top - ib, ib)
    return int((ka - kb).abs().max())


def _inputs(dev, n, nblk, B, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x3d = torch.randn((n, nblk, B), generator=gen, device=dev)
    seeds = randk.seeds_tensor(np.array([5, 2**31 + 1, 2**32 - 1, 77][:n], np.uint32), dev)
    return x3d, seeds, gen


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_randk_and_scatter_accum_on_card(dev, shape):
    n, nblk, B, kb = shape
    x3d, seeds, _ = _inputs(dev, n, nblk, B)
    kernels.reset_launch_counts()
    v, o = randk.randk_seeded_workers(x3d, seeds, kb, B / kb)
    vr, orf = ref.randk_seeded_workers_ref(x3d, seeds, kb, B / kb)
    assert torch.equal(o, orf) and torch.equal(v, vr)
    s = randk.scatter_accum(v, o, B)
    assert torch.equal(_bits(s), _bits(ref.scatter_accum_ref(v, o, B)))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["randk_seeded_workers"] == 1
    assert kernels.launch_counts()["scatter_accum"] == 1


# -- the RandK gathers, rows 1 and 10: bit-equal to their plain versions at
#    every worker count, row width and kb the paths give them (the
#    transport's 2816-wide leaves for row 10), values and offsets, and the
#    NaN of an out-of-range offset

GATHER_NS = [1, 3, 4, 5]
GATHER_WIDTHS = [128, 1024]
GATHER_KBS = ["1", "20", "B"]


def _kb(kb: str, B: int) -> int:
    return B if kb == "B" else int(kb)


@pytest.mark.parametrize("kb", GATHER_KBS)
@pytest.mark.parametrize("B", GATHER_WIDTHS)
@pytest.mark.parametrize("n", GATHER_NS)
def test_randk_seeded_workers_bit_equal_on_card(dev, n, B, kb):
    kb = _kb(kb, B)
    nblk = 37 if kb < B else 5
    x3d, _, _ = _inputs(dev, n, nblk, B, seed=n)
    x3d[0, 0, :3] = torch.tensor([-0.0, float("inf"), float("nan")])
    seeds = randk.seeds_tensor(np.array([5, 2**31 + 1, 2**32 - 1, 77, 0][:n], np.uint32), dev)
    kernels.reset_launch_counts()
    v, o = randk.randk_seeded_workers(x3d, seeds, kb, B / kb)
    vr, orf = ref.randk_seeded_workers_ref(x3d, seeds, kb, B / kb)
    assert torch.equal(o, orf)
    assert torch.equal(_bits(v), _bits(vr))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["randk_seeded_workers"] == 1


#: the bits of the NaN an out-of-range offset gives: the f32 quiet NaN
#: 0x7fc00000, which the device's cvt.rn.bf16.f32 turns into 0x7fff
GATHER_NAN_BITS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FFF}


def _gather_want_bits(x, offs, scale):
    """The plain version's bits at the in-range offsets, the kernel's NaN
    at the others."""
    B = x.shape[1]
    inside = (offs >= 0) & (offs < B)
    want = _bits(ref.randk_block_compress_ref(x, torch.where(inside, offs, 0), scale))
    return torch.where(inside, want, torch.full_like(want, GATHER_NAN_BITS[x.dtype]))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kb", GATHER_KBS)
@pytest.mark.parametrize("B", GATHER_WIDTHS + [2816])
def test_randk_gather_bit_equal_on_card(dev, B, kb, xdtype):
    kb = _kb(kb, B)
    nblk = 41 if kb < B else 6
    gen = torch.Generator(device=dev).manual_seed(B + kb)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    x[0, :3] = torch.tensor([-0.0, float("inf"), -float("inf")])
    offs = torch.randint(0, B, (nblk, kb), generator=gen, device=dev, dtype=torch.int32)
    kernels.reset_launch_counts()
    got = randk.randk_gather(x, offs, B / kb)
    assert torch.equal(_bits(got), _bits(ref.randk_block_compress_ref(x, offs, B / kb)))
    # out-of-range offsets (a column split's dropped slots) give NaN and
    # leave the others as they were
    bad = torch.tensor([-1, B, B + 5, 2**31 - 1, -2**31], dtype=torch.int32, device=dev)
    flat = offs.view(-1)
    flat[::3] = bad.repeat(flat[::3].numel() // 5 + 1)[:flat[::3].numel()]
    got = randk.randk_gather(x, offs, B / kb)
    assert torch.equal(_bits(got), _gather_want_bits(x, offs, B / kb))
    assert bool(torch.isnan(got.view(-1)[::3]).all())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["randk_gather"] == 2


def test_gathers_leave_the_l2_fetch_granularity_as_it_was(dev):
    """The port reads the context's L2 fetch granularity and never sets it:
    rows 1, 10 and 11 leave it at the runtime's default."""
    before = randk.fetch_granularity(dev)
    assert before > 0
    x3d, seeds, _ = _inputs(dev, 4, 37, 1024)
    v, o = randk.randk_seeded_workers(x3d, seeds, 20, 1024 / 20)
    randk.randk_gather(x3d[0], o[0], 1024 / 20)
    randk.randk_seeded(x3d[0], 7, 20, 1024 / 20)
    torch.cuda.synchronize()
    assert randk.fetch_granularity(dev) == before


#: scatter_accum's shapes beyond SHAPES: kb = B with n = 33 (a chunk of 32
#: pairs a round, many rounds a block) at B = 1024 and below 128, where a
#: warp's row is shorter than its 32 lanes' float4s, down to B = 2 and 1
#: (no float4 at all); then the launch layer's per-leaf widths: Qwen1.5-0.5B's
#: MLP leaf (L = 2816, kb = 22), qwen3-32b's (L = 25,600, one warp a CTA), rows
#: that are not 16-byte aligned (L = 1001, 9001: one float a lane) and the
#: widest row a CTA's shared memory holds (58,112)
SCATTER_SHAPES = SHAPES + [(33, 5, B, B) for B in (8, 32, 128, 1024)] + [
    (3, 7, 2, 2), (2, 9, 1, 1), (4, 37, 2816, 22), (4, 5, 25600, 200), (3, 7, 1001, 7),
    (2, 9, 9001, 70), (4, 3, randk.MAX_SCATTER_WIDTH, 454)]


@pytest.mark.parametrize("spread", ["dups", "spread"])
@pytest.mark.parametrize("shape", SCATTER_SHAPES, ids=str)
def test_scatter_accum_bit_equal_on_card(dev, shape, spread):
    """Bit-equal to the plain version, one launch. ``dups``: offsets drawn
    from [0, 4), so each block's n·kb adds pile onto four coordinates and a
    chunk of 32 pairs takes many rounds; ``spread``: offsets over [0, B)."""
    n, nblk, B, kb = shape
    gen = torch.Generator(device=dev).manual_seed(n * 1000 + B + kb)
    v = torch.randn((n, nblk, kb), generator=gen, device=dev)
    hi = min(4, B) if spread == "dups" else B
    o = torch.randint(0, hi, (n, nblk, kb), generator=gen, device=dev).to(torch.int32)
    kernels.reset_launch_counts()
    got = randk.scatter_accum(v, o, B)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref.scatter_accum_ref(v, o, B)))
    assert kernels.launch_counts()["scatter_accum"] == 1


@pytest.mark.parametrize("shape", [(3, 6, 128, 40), (2, 4, 2, 3), (4, 37, 1024, 20)],
                         ids=str)
def test_scatter_accum_drops_offsets_outside_the_block_on_card(dev, shape):
    """Offsets outside [0, B) (negative, B, past B, the int32 extremes) add
    nothing: the output equals a numpy loop in (w, t) order that skips them,
    bit for bit."""
    n, nblk, B, kb = shape
    gen = torch.Generator(device=dev).manual_seed(B + kb)
    v = torch.randn((n, nblk, kb), generator=gen, device=dev)
    o = torch.randint(-3, B + 3, (n, nblk, kb), generator=gen, device=dev).to(torch.int32)
    o[0, 0, :3] = torch.tensor([-2**31, 2**31 - 1, B], device=dev)
    got = randk.scatter_accum(v, o, B)
    want = torch.from_numpy(ordered_scatter_mean(v.cpu().numpy(), o.cpu().numpy(), B))
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_epilogues_on_card(dev, shape, xdtype):
    n, nblk, B, kb = shape
    x3d, seeds, gen = _inputs(dev, n, nblk, B, seed=1)
    g = torch.randn((nblk, B), generator=gen, device=dev)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    v, o = randk.randk_seeded_workers(x3d, seeds, kb, B / kb)
    for got, want in (
        (epilogue.scatter_epilogue(v, o, g, x, 0.0371),
         ref.scatter_epilogue_ref(v, o, g, x, 0.0371)),
        (epilogue.mean_epilogue(x3d, x, 0.0371), ref.mean_epilogue_ref(x3d, x, 0.0371)),
    ):
        assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
        assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(7, 1024, 20), (40, 128, 1), (9, 256, 33),
                                   (300, 2816, 22), (5, 1001, 7)], ids=str)
def test_gather_yardstick_matches_its_plain_version_on_card(dev, shape):
    from repro_torch.kernels import yardstick

    rows, B, kb = shape
    x2d = torch.randn((rows, B), generator=torch.Generator(device=dev).manual_seed(rows),
                      device=dev)
    for unroll, threads in yardstick.SWEEP:
        v, o = yardstick.gather(x2d, kb, unroll, threads)
        vr, orf = yardstick.gather_ref(x2d, kb)
        assert torch.equal(o, orf) and torch.equal(_bits(v), _bits(vr))


@pytest.mark.parametrize("shape", [(4, 9, 1024), (2, 5, 128), (8, 3, 256)], ids=str)
def test_affine_yardstick_gathers_permk_offsets_on_card(dev, shape):
    """The affine yardstick gathers row 12's own offsets: its values ×n are
    ``permk_seeded_workers``' values."""
    from repro_torch.kernels import yardstick

    n, nblk, B = shape
    x3d = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    seed = 2**31 + 12345
    pv, po = ref.permk_seeded_workers_ref(x3d, seed)
    for unroll, threads in yardstick.SWEEP:
        v, o = yardstick.affine(x3d, seed, unroll, threads)
        assert torch.equal(o, po) and torch.equal(v * n, pv)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x3d, seeds, _ = _inputs(dev, 2, 3, 128)
    with pytest.raises(ValueError):
        randk.randk_seeded_workers(x3d.double(), seeds, 8, 16.0)
    with pytest.raises(ValueError):
        randk.randk_seeded_workers(x3d, seeds.long(), 8, 16.0)
    v, o = randk.randk_seeded_workers(x3d, seeds, 8, 16.0)
    with pytest.raises(ValueError):
        epilogue.scatter_epilogue(v, o, torch.zeros(3, 128, device=dev),
                                  torch.zeros(3, 128, device=dev, dtype=torch.float16), 0.1)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 37, 1024), (8, 5, 1024), (2, 9, 128), (1, 3, 256),
                                   (64, 2, 1024), (4, 1321, 1024), (2, 7, 4)], ids=str)
def test_permk_seeded_workers_on_card(dev, shape, xdtype):
    """Bit-equal offsets and values (the ×n scale is exact) in every mode —
    with offsets, ``offsets=False``, and ``workers`` subsets of the fleet
    (a list and a device tensor) — including a fleet whose rows are staged
    in several passes (n = 64), an nblk that leaves the persistent grid's
    last wave partly empty (1321 blocks), rows under 16 bytes (B = 4 in bf16) and an
    unaligned view (both staged element by element); one launch a call."""
    n, nblk, B = shape
    x3d = _inputs(dev, n, nblk, B, seed=2)[0].to(xdtype)
    sub = list(dict.fromkeys([n - 1, n // 2 - 1 if n > 1 else 0, 0]))
    xs = x3d[sub].contiguous()
    kernels.reset_launch_counts()
    calls = 0
    for seed in (0, 2**31 + 7, 2**32 - 1):
        v, o = permk.permk_seeded_workers(x3d, seed)
        vr, orf = ref.permk_seeded_workers_ref(x3d, seed)
        assert v.dtype == xdtype and torch.equal(o, orf) and torch.equal(v, vr)
        nv, no = permk.permk_seeded_workers(x3d, seed, offsets=False)
        assert no is None and torch.equal(nv, vr)
        for workers in (sub, torch.tensor(sub, dtype=torch.int32, device=dev)):
            for offsets in (True, False):
                sv, so = permk.permk_seeded_workers(xs, seed, workers=workers, n=n,
                                                    offsets=offsets)
                svr, sor = ref.permk_seeded_workers_ref(xs, seed, workers=sub, n=n,
                                                        offsets=offsets)
                assert torch.equal(sv, svr) and torch.equal(sv, vr[sub])
                assert (so is None and sor is None) if not offsets else (
                    torch.equal(so, sor) and torch.equal(so, orf[sub]))
        calls += 6
    # an unaligned view takes the kernel's element-by-element staging path
    flat = torch.empty(x3d.numel() + 1, dtype=xdtype, device=dev)
    xv = flat[1:].view(x3d.shape)
    xv.copy_(x3d)
    assert torch.equal(permk.permk_seeded_workers(xv, 5)[0],
                       ref.permk_seeded_workers_ref(xv, 5)[0])
    assert torch.equal(permk.permk_seeded_workers(xv, 5, offsets=False)[0],
                       ref.permk_seeded_workers_ref(xv, 5)[0])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["permk_seeded_workers"] == calls + 2


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_delta_epilogue_on_card(dev, xdtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    delta, g, x = (torch.randn((41, 1024), generator=gen, device=dev) for _ in range(3))
    x = x.to(xdtype)
    kernels.reset_launch_counts()
    got = epilogue.delta_epilogue(delta, g, x, 0.0371)
    want = ref.delta_epilogue_ref(delta, g, x, 0.0371)
    assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
    assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()
    assert kernels.launch_counts()["delta_epilogue"] == 1


def test_permk_and_delta_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x3d = _inputs(dev, 4, 3, 128)[0]
    with pytest.raises(ValueError):
        permk.permk_seeded_workers(x3d.double(), 1)
    with pytest.raises(ValueError):
        permk.permk_seeded_workers(x3d[:3], 1)  # 3 workers do not divide 128
    with pytest.raises(ValueError):
        permk.permk_seeded_workers(torch.zeros(4, 3, 256, device=dev)[..., ::2], 1)
    for kw in ({"workers": [0, 4], "n": 4}, {"workers": [0, 1], "n": 3},
               {"workers": torch.tensor([0, 1]), "n": 4}):  # indices on the host
        with pytest.raises(ValueError):
            permk.permk_seeded_workers(x3d[:2].contiguous(), 1, **kw)
    g = torch.zeros(3, 128, device=dev)
    with pytest.raises(ValueError):
        epilogue.delta_epilogue(g.double(), g, g, 0.1)
    with pytest.raises(ValueError):
        epilogue.delta_epilogue(g, g, g.half(), 0.1)


QSHAPES = [(4, 37, 1024), (1, 5, 128), (3, 11, 256), (2, 3, 4096)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QSHAPES, ids=str)
def test_qsgd_block_workers_on_card(dev, shape, xdtype):
    """Levels and norms bit-equal to the plain version (it repeats the
    kernel's order of the norm's sum), with zeros, −0.0 and an all-zero
    block, for s = 1, 7 and 127."""
    n, nblk, B = shape
    x3d, seeds, _ = _inputs(dev, n, nblk, B, seed=4)
    x3d[0, 0, :5] = 0.0
    x3d[0, 0, 5:9] = -0.0
    x3d[-1, -1] = 0.0
    x3d = (x3d * 3.0).to(xdtype)
    kernels.reset_launch_counts()
    for s in (1, 7, 127):
        lv, nm = quantize.qsgd_block_workers(x3d, seeds, s)
        lr, nr = ref.qsgd_block_workers_ref(x3d, seeds, s)
        assert lv.dtype == torch.int8 and nm.dtype == torch.float32
        assert torch.equal(nm, nr) and torch.equal(lv, lr)
        assert int(lv.abs().max()) <= s
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qsgd_block_workers"] == 3


@pytest.mark.parametrize("shape", [(37, 1024), (5, 128), (1, 8)], ids=str)
def test_nibble_pack_and_unpack_on_card(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randint(-8, 8, shape, generator=gen, device=dev, dtype=torch.int8)
    kernels.reset_launch_counts()
    words = quantize.nibble_pack(q)
    assert words.dtype == torch.int32 and torch.equal(words, ref.nibble_pack_ref(q))
    back = quantize.nibble_unpack(words, shape[1])
    assert torch.equal(back, q) and torch.equal(back, ref.nibble_unpack_ref(words, shape[1]))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["nibble_pack"] == counts["nibble_unpack"] == 1


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QSHAPES, ids=str)
def test_qsgd_dequant_mean_and_epilogue_on_card(dev, shape, xdtype):
    n, nblk, B = shape
    x3d, seeds, gen = _inputs(dev, n, nblk, B, seed=6)
    g = torch.randn((nblk, B), generator=gen, device=dev)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    kernels.reset_launch_counts()
    for s in (3, 7, 15):
        lv, nm = quantize.qsgd_block_workers(x3d, seeds, s)
        assert torch.equal(_bits(quantize.qsgd_dequant_mean(lv, nm, s)),
                           _bits(ref.qsgd_dequant_mean_ref(lv, nm, s)))
        got = epilogue.qsgd_epilogue(lv, nm, g, x, 0.0371, s)
        want = ref.qsgd_epilogue_ref(lv, nm, g, x, 0.0371, s)
        assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
        assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["qsgd_dequant_mean"] == counts["qsgd_epilogue"] == 3


@pytest.mark.parametrize("B", [128, 1024, 4096])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 33])
def test_qsgd_dequant_mean_bit_equal_on_card(dev, n, B):
    """Bit-equal to the plain version, one launch: n ≤ 4 unrolled, 5, 8 and
    33 the runtime loop (33: a second round of shuffles), 1, 2, 4, 8 the
    exact multiply by 1/n and 3, 5, 33 the true divide. Levels span ±s with
    whole rows at ±s, one row's norm is 0 and the norms span many octaves;
    at B = 128 the 7 blocks leave part of the one CTA idle."""
    gen = torch.Generator(device=dev).manual_seed(n * 10 + B)
    s, nblk = 7, 7
    lv = torch.randint(-s, s + 1, (n, nblk, B), generator=gen, device=dev).to(torch.int8)
    lv[0, 1], lv[-1, 2] = s, -s
    nm = torch.rand((n, nblk), generator=gen, device=dev) * 2.0 ** torch.randint(
        -30, 30, (n, nblk), generator=gen, device=dev)
    nm[-1, 0] = 0.0
    kernels.reset_launch_counts()
    got = quantize.qsgd_dequant_mean(lv, nm, s)
    assert torch.equal(_bits(got), _bits(ref.qsgd_dequant_mean_ref(lv, nm, s)))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qsgd_dequant_mean"] == 1


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nblk,B", [(1, 128), (37, 1024), (5, 256)], ids=str)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 33])
def test_qsgd_epilogue_bit_equal_on_card(dev, n, nblk, B, xdtype):
    """g' and x' bit-equal to the plain version, one launch: n = 33 takes
    the warp's second round of norm_w / s (workers 32..), nblk = 1 a single
    block, nblk odd a grid whose last CTA is partial. Levels span ±s with
    zero-norm rows among them."""
    gen = torch.Generator(device=dev).manual_seed(n * 100 + nblk)
    s = 7
    lv = torch.randint(-s, s + 1, (n, nblk, B), generator=gen, device=dev).to(torch.int8)
    nm = torch.rand((n, nblk), generator=gen, device=dev) * 10
    nm[0, 0] = 0.0
    g = torch.randn((nblk, B), generator=gen, device=dev)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    kernels.reset_launch_counts()
    got = epilogue.qsgd_epilogue(lv, nm, g, x, 0.0371, s)
    torch.cuda.synchronize()
    want = ref.qsgd_epilogue_ref(lv, nm, g, x, 0.0371, s)
    assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert kernels.launch_counts()["qsgd_epilogue"] == 1


def test_qsgd_engine_and_downlink_on_card(dev):
    """The qsgd engine's aggregate and fused round, and a RandK round under
    a QSGD downlink, through the kernels equal the plain versions'."""
    from repro_torch import prng
    from repro_torch.core import make_downlink, make_engine

    tree = {"w": torch.zeros(40, 70), "b": torch.zeros(500)}
    gen = torch.Generator(device=dev).manual_seed(7)
    for sampler in ("qsgd", "randk"):
        eng = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7)
        plain = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7,
                            backend="ref")
        down = make_downlink(eng, sampler="qsgd") if sampler == "randk" else None
        down_plain = make_downlink(plain, sampler="qsgd") if sampler == "randk" else None
        lay = eng.layout
        bufs = torch.randn((3, lay.nblk, lay.block), generator=gen, device=dev)
        g = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
        x = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
        key = prng.PRNGKey(42)
        assert torch.equal(eng.aggregate(key, bufs, 3), plain.aggregate(key, bufs, 3))
        got = eng.fused_round(key, bufs, 3, g, x, 0.05, down=down, down_key=key)
        want = plain.fused_round(key, bufs, 3, g, x, 0.05, down=down_plain, down_key=key)
        assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()


def test_quantize_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x3d, seeds, _ = _inputs(dev, 2, 3, 128)
    with pytest.raises(ValueError):
        quantize.qsgd_block_workers(x3d.double(), seeds, 7)
    with pytest.raises(ValueError):
        quantize.qsgd_block_workers(x3d[..., :64].contiguous(), seeds, 7)  # B < 128
    with pytest.raises(ValueError):
        quantize.qsgd_block_workers(x3d, seeds, 200)  # beyond int8
    flat = torch.empty(x3d.numel() + 1, device=dev)
    with pytest.raises(ValueError):
        quantize.qsgd_block_workers(flat[1:].view(x3d.shape), seeds, 7)  # misaligned
    lv, nm = quantize.qsgd_block_workers(x3d, seeds, 7)
    with pytest.raises(ValueError):
        quantize.qsgd_dequant_mean(lv.float(), nm, 7)
    with pytest.raises(ValueError):
        quantize.qsgd_dequant_mean(lv, nm[:1], 7)
    with pytest.raises(ValueError):
        quantize.nibble_pack(lv.reshape(6, 128).int())
    with pytest.raises(ValueError):
        quantize.nibble_unpack(quantize.nibble_pack(lv.reshape(6, 128)), 64)
    g = torch.zeros(3, 128, device=dev)
    with pytest.raises(ValueError):
        epilogue.qsgd_epilogue(lv, nm, g, g.half(), 0.1, 7)


def _natural_inputs(dev, n, nblk, B, xdtype, seed):
    """Random rows over many octaves with the natural wire's edge values:
    zeros, −0.0, subnormals, exact powers of two and the floats just below
    them, an all-zero row, an all-subnormal row, and a row whose max is near
    2^-100 (its smallest codes decode below 2^-126)."""
    x3d, seeds, gen = _inputs(dev, n, nblk, B, seed=seed)
    x3d = x3d * torch.exp2(torch.randint(-20, 20, (n, nblk, 1), generator=gen,
                                         device=dev).float())
    pw = ref.pow2_ref(torch.arange(-126, 127, 7, device=dev))  # exact powers
    edge = torch.cat([pw, torch.nextafter(pw, torch.zeros_like(pw)), -pw,
                      torch.tensor([0.0, -0.0, 1e-40, -3e-39, 2.0**-149], device=dev)])
    x3d[0, 0, :edge.numel()] = edge[:B]
    x3d[-1, -1] = 0.0
    if nblk > 2:
        x3d[0, 1] = 1e-39
        x3d[0, 2] = torch.randn(B, generator=gen, device=dev) * 2.0**-100
    return x3d.to(xdtype), seeds, gen


NSHAPES = [(4, 37, 1024), (1, 5, 128), (3, 11, 256), (2, 3, 4096)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", NSHAPES, ids=str)
def test_natural_block_workers_on_card(dev, shape, xdtype):
    """Codes and scales bit-equal to the plain version, edge values included;
    codes in [−127, 127], scales exact powers of two."""
    n, nblk, B = shape
    x3d, seeds, _ = _natural_inputs(dev, n, nblk, B, xdtype, seed=8)
    kernels.reset_launch_counts()
    codes, scales = quantize.natural_block_workers(x3d, seeds)
    cr, sr = ref.natural_block_workers_ref(x3d, seeds)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert torch.equal(scales, sr) and torch.equal(codes, cr)
    assert int(codes.int().abs().max()) <= 127
    assert torch.equal(torch.frexp(scales).mantissa, torch.full_like(scales, 0.5))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["natural_block_workers"] == 1


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", NSHAPES, ids=str)
def test_natural_dequant_mean_and_epilogue_on_card(dev, shape, xdtype):
    """Decode-and-mean and the epilogue within 1 ulp of the plain versions
    (the same order of adds: bit-equal is expected)."""
    n, nblk, B = shape
    x3d, seeds, gen = _natural_inputs(dev, n, nblk, B, torch.float32, seed=9)
    g = torch.randn((nblk, B), generator=gen, device=dev)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    kernels.reset_launch_counts()
    codes, scales = quantize.natural_block_workers(x3d, seeds)
    assert _ulp(quantize.natural_dequant_mean(codes, scales),
                ref.natural_dequant_mean_ref(codes, scales)) <= 1
    got = epilogue.natural_epilogue(codes, scales, g, x, 0.0371)
    want = ref.natural_epilogue_ref(codes, scales, g, x, 0.0371)
    assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["natural_dequant_mean"] == counts["natural_epilogue"] == 1


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nblk,B", [(1, 128), (37, 1024), (5, 256)], ids=str)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 33])
def test_natural_epilogue_bit_equal_on_card(dev, n, nblk, B, xdtype):
    """g' and x' bit-equal to the plain version, one launch: n ≤ 4 the
    unrolled workers, n = 33 the runtime loop's second round of scales.
    Codes span ±127 with a run of zero codes in every block; scales are
    powers of two from 2^-126 to 2^39 with, among them, 0, 2^-126 (every
    code but ±1 decodes below 2^-126 and flushes, to −0 where c < 0), a
    non-power of two (products rounded once, the small ones flushing) and a
    NaN (a NaN product flushes to 0)."""
    gen = torch.Generator(device=dev).manual_seed(n * 100 + nblk + 7)
    codes = torch.randint(-127, 128, (n, nblk, B), generator=gen, device=dev).to(torch.int8)
    codes[:, :, : B // 8] = 0
    codes[0, 0, B // 8: B // 8 + 8] = torch.tensor([1, -1, 127, -127, 2, -2, 126, -126],
                                                   device=dev)
    scales = ref.pow2_ref(torch.randint(-126, 40, (n, nblk), generator=gen, device=dev))
    edge = torch.tensor([0.0, 2.0**-126, 3.3 * 2.0**-120, float("nan")], device=dev)
    scales.view(-1)[: edge.numel()] = edge[: scales.numel()]
    g = torch.randn((nblk, B), generator=gen, device=dev)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    kernels.reset_launch_counts()
    got = epilogue.natural_epilogue(codes, scales, g, x, 0.0371)
    torch.cuda.synchronize()
    want = ref.natural_epilogue_ref(codes, scales, g, x, 0.0371)
    assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert kernels.launch_counts()["natural_epilogue"] == 1


def test_natural_and_randk_qsgd_engines_on_card(dev):
    """The natural and randk_qsgd engines' aggregate and fused round, and a
    RandK round under a natural downlink, through the kernels equal the
    plain versions'."""
    from repro_torch import prng
    from repro_torch.core import make_downlink, make_engine

    tree = {"w": torch.zeros(40, 70), "b": torch.zeros(500)}
    gen = torch.Generator(device=dev).manual_seed(10)
    for sampler in ("natural", "randk_qsgd", "randk"):
        eng = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7)
        plain = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7,
                            backend="ref")
        down = make_downlink(eng, sampler="natural") if sampler == "randk" else None
        down_plain = make_downlink(plain, sampler="natural") if sampler == "randk" else None
        lay = eng.layout
        bufs = torch.randn((3, lay.nblk, lay.block), generator=gen, device=dev)
        g = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
        x = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
        key = prng.PRNGKey(43)
        assert _ulp(eng.aggregate(key, bufs, 3), plain.aggregate(key, bufs, 3)) <= 1
        got = eng.fused_round(key, bufs, 3, g, x, 0.05, down=down, down_key=key)
        want = plain.fused_round(key, bufs, 3, g, x, 0.05, down=down_plain, down_key=key)
        assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()


def test_natural_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x3d, seeds, _ = _inputs(dev, 2, 3, 128)
    with pytest.raises(ValueError):
        quantize.natural_block_workers(x3d.double(), seeds)
    with pytest.raises(ValueError):
        quantize.natural_block_workers(x3d[..., :64].contiguous(), seeds)  # B < 128
    with pytest.raises(ValueError):
        quantize.natural_block_workers(x3d, seeds[:1])
    codes, scales = quantize.natural_block_workers(x3d, seeds)
    with pytest.raises(ValueError):
        quantize.natural_dequant_mean(codes.float(), scales)
    with pytest.raises(ValueError):
        quantize.natural_dequant_mean(codes, scales[:1])
    g = torch.zeros(3, 128, device=dev)
    with pytest.raises(ValueError):
        epilogue.natural_epilogue(codes, scales, g, g.half(), 0.1)


# ---------------------------------------------------------------------------
# The robust pair: coordinate-wise trimmed mean / median epilogues
# ---------------------------------------------------------------------------

#: (n, lo, hi): the production sync round under trimmed_mean f = 1, PP's
#: cohort (n = r = 2), the odd median, a four-value window (the sum order
#: matters), one row, and the largest n the kernels take
TRIM_WINDOWS = [(4, 1, 3), (2, 0, 2), (5, 2, 3), (8, 2, 6), (1, 0, 1), (16, 3, 13),
                (6, 0, 6)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bit patterns, so −0 and +0 (and NaN payloads) compare unequal."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _trim_edge_rows(dev, n, nblk, B, gen):
    """Normal rows plus the trimmed kernels' edge values: a NaN row (where
    the window starts past it), ±inf, ties across workers and ±0."""
    rows = torch.randn((n, nblk, B), generator=gen, device=dev)
    if n > 1:
        rows[1, :, : B // 4] = rows[0, :, : B // 4]          # ties
    rows[:, 0, :16] = 0.0
    rows[: n // 2, 0, :16] = -0.0                           # ±0 across workers
    rows[0, 0, 16:24] = -0.0
    rows[n - 1, 1, :8] = float("inf")
    rows[0, 1, 8:16] = float("-inf")
    rows[0, 2 % nblk] = float("nan")                          # a NaN row
    return rows


@pytest.mark.parametrize("bdtype", [torch.float32, torch.bfloat16], ids=["b_f32", "b_bf16"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("window", TRIM_WINDOWS, ids=str)
def test_trimmed_epilogues_on_card(dev, window, xdtype, bdtype):
    n, lo, hi = window
    nblk, B = 7, 1024
    gen = torch.Generator(device=dev).manual_seed(n * 100 + lo)
    rows = _trim_edge_rows(dev, n, nblk, B, gen).to(bdtype)
    g = torch.randn((nblk, B), generator=gen, device=dev)
    g[0, :32] = -0.0
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    kernels.reset_launch_counts()
    for got, want in (
        (epilogue.trimmed_delta_epilogue(rows, g, x, 0.0371, lo, hi),
         ref.trimmed_delta_epilogue_ref(rows, g, x, 0.0371, lo, hi)),
        (epilogue.trimmed_sync_epilogue(rows, x, 0.0371, lo, hi),
         ref.trimmed_sync_epilogue_ref(rows, x, 0.0371, lo, hi)),
    ):
        assert got[0].dtype == torch.float32 and got[1].dtype == xdtype
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        assert torch.equal(_bits(got[1]), _bits(want[1]))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["trimmed_delta_epilogue"] == counts["trimmed_sync_epilogue"] == 1


def test_trimmed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rows = torch.zeros((4, 3, 128), device=dev)
    g = torch.zeros((3, 128), device=dev)
    for lo, hi in ((2, 2), (-1, 2), (0, 5)):
        with pytest.raises(ValueError, match="window"):
            epilogue.trimmed_sync_epilogue(rows, g, 0.1, lo, hi)
    with pytest.raises(ValueError, match="worker rows"):
        epilogue.trimmed_sync_epilogue(torch.zeros((17, 3, 128), device=dev), g, 0.1, 1, 3)
    with pytest.raises(ValueError, match="bufs"):
        epilogue.trimmed_sync_epilogue(rows.half(), g, 0.1, 1, 3)
    with pytest.raises(ValueError, match="bufs"):
        epilogue.trimmed_delta_epilogue(rows.transpose(1, 2), g, g, 0.1, 1, 3)
    with pytest.raises(ValueError, match="g must"):
        epilogue.trimmed_delta_epilogue(rows, g.bfloat16(), g, 0.1, 1, 3)
    with pytest.raises(ValueError, match="x must"):
        epilogue.trimmed_delta_epilogue(rows, g, g[:2], 0.1, 1, 3)


@pytest.mark.parametrize("sampler", ["qsgd", "natural", "randk", "randk_qsgd"])
def test_robust_engine_rounds_on_card(dev, sampler):
    """The flat engine under every robust rule, through the kernels, agrees
    with its plain versions (backend "ref") on the card within 1 ulp, as the
    scatter kernels do: each worker's decoded rows, the recompute
    aggregate, the carry round and the sync round."""
    from repro_torch import prng
    from repro_torch.core import ServerAggregator, make_engine

    tree = {"w": torch.zeros(40, 70), "b": torch.zeros(500)}
    gen = torch.Generator(device=dev).manual_seed(11)
    eng = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7)
    plain = make_engine(tree, kb=8, block=256, device=dev, sampler=sampler, s=7,
                        backend="ref")
    lay, n, key = eng.layout, 4, prng.PRNGKey(44)
    bufs = torch.randn((n, lay.nblk, lay.block), generator=gen, device=dev)
    g = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
    x = torch.randn((lay.nblk, lay.block), generator=gen, device=dev)
    assert _ulp(eng.worker_dense(key, bufs, n), plain.worker_dense(key, bufs, n)) <= 1
    for agg in (ServerAggregator("trimmed_mean", 1), ServerAggregator("coordinate_median"),
                ServerAggregator("krum", 1), ServerAggregator("norm_clip")):
        assert _ulp(eng.aggregate(key, bufs, n, agg), plain.aggregate(key, bufs, n, agg)) <= 1
        for got, want in ((eng.fused_round(key, bufs, n, g, x, 0.05, aggregator=agg),
                           plain.fused_round(key, bufs, n, g, x, 0.05, aggregator=agg)),
                          (eng.fused_sync(bufs, x, 0.05, aggregator=agg),
                           plain.fused_sync(bufs, x, 0.05, aggregator=agg))):
            assert _ulp(got[0], want[0]) <= 1 and _ulp(got[1], want[1]) <= 1
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# serving: the int8 KV rows and the paged decode attention
# ---------------------------------------------------------------------------


def _absmax_edge(dev, W):
    rows = torch.zeros((5, W), device=dev)
    rows[1] = 127.0
    rows[1, ::2] = torch.arange(W // 2, device=dev) % 127 + 0.5
    rows[2, : W // 2] = -0.0
    rows[3] = torch.linspace(-254.0, 254.0, W, device=dev)
    rows[4] = 2.5 * torch.sign(torch.arange(W, device=dev) % 3 - 1.0)
    return rows


@pytest.mark.parametrize("R,W", [(1, 32), (128, 64), (2048, 64), (777, 128), (33, 256)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=str)
def test_absmax_rows_bit_equal_on_card(dev, R, W, xdtype):
    gen = torch.Generator(device=dev).manual_seed(R + W)
    x = torch.randn((R, W), generator=gen, device=dev) * 5
    if R >= 5:
        x[:5] = _absmax_edge(dev, W)
    x = x.to(xdtype)
    kernels.reset_launch_counts()
    c, s = quantize.absmax_quant_rows(x)
    cr, sr = ref.absmax_quant_rows_ref(x)
    assert torch.equal(c, cr) and torch.equal(_bits(s), _bits(sr))
    d = quantize.absmax_dequant_rows(c, s)
    assert torch.equal(_bits(d), _bits(ref.absmax_dequant_rows_ref(c, s)))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["absmax_quant_rows"] == counts["absmax_dequant_rows"] == 1


@pytest.mark.parametrize("W", [32, 64, 128, 256, 16, 4, 8, 36, 100])
def test_absmax_dequant_rows_widths_bit_equal_on_card(dev, W):
    """The shift path (W a power of two ≥ 16) and the tail branch (any other
    multiple of 4; 333 rows leave the last thread fewer than 16 codes where
    W is not a multiple of 16), bit-equal, one launch."""
    gen = torch.Generator(device=dev).manual_seed(W)
    c = torch.randint(-128, 128, (333, W), generator=gen, device=dev).to(torch.int8)
    s = torch.randn((333,), generator=gen, device=dev)
    s[::7] = -0.0
    kernels.reset_launch_counts()
    d = quantize.absmax_dequant_rows(c, s)
    torch.cuda.synchronize()
    assert torch.equal(_bits(d), _bits(ref.absmax_dequant_rows_ref(c, s)))
    assert kernels.launch_counts()["absmax_dequant_rows"] == 1


def test_absmax_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError, match="row width"):
        quantize.absmax_quant_rows(torch.zeros((4, 48), device=dev))
    with pytest.raises(ValueError, match="f32 or bf16"):
        quantize.absmax_quant_rows(torch.zeros((4, 64), device=dev).half())
    with pytest.raises(ValueError, match="row width"):
        quantize.absmax_dequant_rows(torch.zeros((4, 6), dtype=torch.int8, device=dev),
                                     torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="scales must"):
        quantize.absmax_dequant_rows(torch.zeros((4, 64), dtype=torch.int8, device=dev),
                                     torch.zeros(5, device=dev))


def _write_pages_case(dev, T, KV, W, xdtype, npage=9, P=4, seed=0):
    """Token-strided k / v rows (halves of one (T, 2, KV, W) buffer) with
    edge rows, a pool with random earlier contents, and (T,) int32 maps:
    about half the tokens at distinct rows of pages ≥ 1, the rest on the
    null page, repeated rows included."""
    gen = torch.Generator(device=dev).manual_seed(seed + T + W)
    kv = torch.randn((T, 2, KV, W), generator=gen, device=dev) * 5
    kv[0, 0] = _absmax_edge(dev, W)[torch.arange(KV) % 5]
    kv = kv.to(xdtype)
    n_real = min(T // 2 + 1, (npage - 1) * P)
    slots = torch.randperm((npage - 1) * P, generator=gen, device=dev)[:n_real]
    page = torch.zeros(T, dtype=torch.int64, device=dev)
    row = torch.randint(0, 2, (T,), generator=gen, device=dev)
    page[:n_real], row[:n_real] = 1 + slots // P, slots % P
    order = torch.randperm(T, generator=gen, device=dev)
    page, row = page[order].to(torch.int32), row[order].to(torch.int32)
    shape = (npage, P, KV, W)
    pool = {"kq": torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8),
            "vq": torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8),
            "k_scale": torch.rand(shape[:3], generator=gen, device=dev),
            "v_scale": torch.rand(shape[:3], generator=gen, device=dev)}
    return kv[:, 0], kv[:, 1], pool, page, row


@pytest.mark.parametrize("T,KV", [(8, 16), (128, 2), (1, 3), (8, 8), (128, 8)], ids=str)
@pytest.mark.parametrize("W", list(quantize.ABSMAX_WIDTHS))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_absmax_write_pages_bit_equal_on_card(dev, T, KV, W, xdtype):
    """The one-launch int8 page write of k and v against its plain version:
    every row of pages ≥ 1 bit-equal (codes, scales, the sign of zero),
    page 0 (where idle tokens race) not compared; one launch, counted as
    absmax_quant_rows."""
    k, v, pool, page, row = _write_pages_case(dev, T, KV, W, xdtype)
    got = {key: t.clone() for key, t in pool.items()}
    want = {key: t.clone() for key, t in pool.items()}
    kernels.reset_launch_counts()
    assert quantize.absmax_quant_write_pages(k, v, got, page, row) is None
    torch.cuda.synchronize()
    assert kernels.launch_counts()["absmax_quant_rows"] == 1
    ref.absmax_quant_write_pages_ref(k, v, want, page, row)
    for key in ("kq", "vq", "k_scale", "v_scale"):
        a, b = got[key][1:], want[key][1:]
        if a.dtype == torch.float32:
            a, b = _bits(a), _bits(b)
        assert torch.equal(a, b), key


def test_absmax_write_pages_refuses_what_the_kernel_does_not_take(dev):
    k, v, pool, page, row = _write_pages_case(dev, 8, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        quantize.absmax_quant_write_pages(k.half(), v.half(), pool, page, row)
    with pytest.raises(ValueError, match="one dtype"):
        quantize.absmax_quant_write_pages(k, v.bfloat16(), pool, page, row)
    with pytest.raises(ValueError, match="row width"):
        quantize.absmax_quant_write_pages(k[..., :48], v[..., :48], pool, page, row)
    with pytest.raises(ValueError, match="contiguous"):
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)  # (KV, W) part transposed
        quantize.absmax_quant_write_pages(kt, kt, pool, page, row)
    with pytest.raises(ValueError, match="int32"):
        quantize.absmax_quant_write_pages(k, v, pool, page.long(), row)
    with pytest.raises(ValueError, match="int8 codes and f32"):
        quantize.absmax_quant_write_pages(k, v, dict(pool, k_scale=pool["k_scale"].double()),
                                          page, row)
    with pytest.raises(ValueError, match="pools must be"):
        quantize.absmax_quant_write_pages(k, v, dict(pool, vq=pool["vq"][:, :, :2]),
                                          page, row)


def _paged(dev, S, H, KV, hd, P, maxp, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    npage = 1 + S * maxp
    q = torch.randn((S, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((npage, P, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((npage, P, KV, hd), generator=gen, device=dev).to(dtype)
    tables = (torch.randperm(npage - 1, generator=gen, device=dev) + 1).to(torch.int32)
    tables = tables.reshape(S, maxp).contiguous()
    n_valid = torch.randint(1, maxp * P + 1, (S,), generator=gen, device=dev)
    n_valid[0] = 1
    n_valid[-1] = maxp * P
    return q, kp, vp, tables, n_valid.to(torch.int32)


def _within_paged_bound(out, want, vp):
    """f32: |Δ| ≤ 1e-5·max|v|; bf16: one bf16 ulp of each output row's
    largest magnitude (ROADMAP C)."""
    diff = (out.float() - want.float()).abs()
    if out.dtype == torch.float32:
        return bool((diff <= 1e-5 * vp.float().abs().max()).all())
    top = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0**-126)
    return bool((diff <= torch.exp2(torch.floor(torch.log2(top)) - 7)).all())


#: (S, H, KV, hd, P, max_pages); the last four at H / KV = 5 and 7: the
#: Llama-4-Scout decode shape (40 / 8), DeepSeek-Coder-33B's ratio (56 / 8)
#: and InternVL2-1B's (14 / 2, hd 64), and 5 at hd 64
@pytest.mark.parametrize("shape", [(3, 4, 2, 32, 4, 5), (8, 16, 16, 64, 16, 36),
                                   (5, 64, 8, 128, 16, 12), (2, 8, 8, 64, 8, 3),
                                   (8, 40, 8, 128, 16, 36), (8, 56, 8, 128, 16, 36),
                                   (4, 14, 2, 64, 16, 12), (3, 15, 3, 64, 8, 9)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_paged_attn_decode_within_bound_on_card(dev, shape, dtype):
    q, kp, vp, tables, n_valid = _paged(dev, *shape, dtype)
    kernels.reset_launch_counts()
    out = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
    want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert _within_paged_bound(out, want, vp)
    assert kernels.launch_counts()["paged_attn_decode"] == 1


@pytest.mark.parametrize("geom", [(2, 4, 13), (2, 16, 70)], ids=str)
@pytest.mark.parametrize("hd", paged.HEAD_DIMS)
@pytest.mark.parametrize("rep", paged.GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_paged_attn_decode_cluster_edges_on_card(dev, geom, hd, rep, dtype):
    """Every (hd, rep) instantiation at the cluster split's edges: n_valid =
    1 (every other rank of the cluster empty), on a page boundary, on a
    split boundary (C pages: each rank one) and one past it, 0 and −3
    (uniform over the row), past L (clamped); max_pages not a multiple of C;
    one launch per call. The second geometry gives each rank several
    32-position tiles."""
    KV, P, maxp = geom
    q, kp, vp, tables, _ = _paged(dev, 9, rep * KV, KV, hd, P, maxp, dtype, seed=hd + rep)
    C, _ = paged.launch_plan(9, KV, hd, rep, P, maxp, q.element_size())
    assert C > 1 and maxp % C
    L = maxp * P
    n_valid = torch.tensor([1, P, C * P, C * P + 1, 0, -3, L, L + 9, P + 1],
                           dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    out = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
    want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attn_decode"] == 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert _within_paged_bound(out, want, vp)


def test_paged_attn_decode_null_page_and_all_masked_rows(dev):
    """Garbage (inf / NaN) in the null page past n_valid is never read; a
    slot with n_valid = 0 averages its whole row, as the reference does."""
    q, kp, vp, tables, n_valid = _paged(dev, 3, 4, 2, 64, 4, 4, torch.float32, seed=3)
    tables[1, 2:] = 0
    n_valid[1] = 7
    # the plain version multiplies masked positions by a zero weight, so it
    # sees finite garbage; the kernel must not read the null page at all
    want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
    kp[0], vp[0] = float("inf"), float("nan")
    out = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
    assert torch.isfinite(out).all() and _within_paged_bound(out, want, vp[1:])
    n_valid[0] = 0
    kp[0], vp[0] = 0.5, 0.25
    out = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
    want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
    assert _within_paged_bound(out, want, vp)


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, kp, vp, tables, n_valid = _paged(dev, 2, 4, 2, 32, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="hd"):
        paged.paged_attn_decode(q[..., :16].contiguous(), kp[..., :16].contiguous(),
                                vp[..., :16].contiguous(), tables, n_valid)
    with pytest.raises(ValueError, match="one dtype"):
        paged.paged_attn_decode(q.bfloat16(), kp, vp, tables, n_valid)
    with pytest.raises(ValueError, match="int32"):
        paged.paged_attn_decode(q, kp, vp, tables.long(), n_valid)
    for H in (5, 18):  # H not a multiple of KV; H / KV = 9 > 8
        with pytest.raises(ValueError, match="H / KV"):
            paged.paged_attn_decode(torch.zeros((2, H, 32), device=dev), kp, vp, tables,
                                    n_valid)


@pytest.mark.parametrize("shape", [(4, 8, 2, 64, 8, 5), (8, 40, 8, 128, 16, 36)], ids=str)
def test_paged_q8_route_on_card(dev, shape):
    """The int8 route through the dequant kernel equals its plain version
    bit for bit (the attention after the dequant is the same torch code);
    also at the Llama-4-Scout decode shape (KV = 8, hd = 128)."""
    q, kp, vp, tables, n_valid = _paged(dev, *shape, torch.float32, seed=5)
    hd = shape[3]
    kc, ks = ref.absmax_quant_rows_ref(kp.reshape(-1, hd))
    vc, vs = ref.absmax_quant_rows_ref(vp.reshape(-1, hd))
    args = (q, kc.reshape(kp.shape), vc.reshape(vp.shape), ks.reshape(kp.shape[:3]),
            vs.reshape(vp.shape[:3]), tables, n_valid)
    kernels.reset_launch_counts()
    out = paged.paged_attn_decode_q8(*args)
    assert torch.equal(out, ref.paged_attn_decode_q8_ref(*args))
    assert kernels.launch_counts()["absmax_dequant_rows"] == 2


@pytest.mark.parametrize("quantized", [False, True])
def test_serve_on_card_matches_plain_versions(dev, quantized):
    """A reduced GQA LM served continuously on the card through the kernels
    and through their plain versions: identical greedy streams (a near tie
    aside, which this seed does not hit), one launch per layer and step."""
    from repro_torch.launch import serve
    from repro_torch.models import ModelConfig, dense_stack, init_params

    cfg = ModelConfig(name="tiny-gqa", arch_type="dense", d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=256, vocab_size=512, segments=dense_stack(2),
                      qk_norm=True, head_dim=32)
    params = init_params(0, cfg, device=dev)
    pairs = serve.parse_requests("9:6,3:4,14:5,6:7,2:3")
    streams = []
    for backend in ("auto", "ref"):
        reqs = serve.make_workload(cfg, pairs)
        kernels.reset_launch_counts()
        rep = serve.run_continuous(params, cfg, reqs, slots=3, page_size=4, chunk=4,
                                   quantized=quantized, backend=backend, npage=8)
        counts = kernels.launch_counts()
        if backend == "auto" and quantized:  # k and v: one write, two dequants a layer
            assert counts["absmax_quant_rows"] == 2 * (rep.prefill_chunks + rep.decode_steps)
            assert counts["absmax_dequant_rows"] == 4 * rep.decode_steps
        elif backend == "auto":
            assert counts["paged_attn_decode"] == 2 * rep.decode_steps
        else:
            assert not any(counts.values())
        streams.append([r.generated for r in reqs])
    assert streams[0] == streams[1]


# -- the flat-vector wire: randk_gather, randk_seeded, block_sumsq,
#    qsgd_quantize, qsgd_dequantize ----------------------------------------

WIRE_SHAPES = [(37, 1024, 20), (11, 256, 16), (5, 128, 8), (3, 384, 24)]


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WIRE_SHAPES, ids=str)
def test_flat_wire_gathers_bit_equal_on_card(dev, shape, xdtype):
    nblk, B, kb = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((nblk, B), generator=gen, device=dev).to(xdtype)
    x[0, :3] = torch.tensor([-0.0, float("inf"), -float("inf")])
    offs = torch.randint(0, B, (nblk, kb), generator=gen, device=dev, dtype=torch.int32)
    offs[0, :3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    kernels.reset_launch_counts()
    got = randk.randk_gather(x, offs, B / kb)
    assert torch.equal(_bits(got), _bits(ref.randk_block_compress_ref(x, offs, B / kb)))
    seeded = 3 if B & (B - 1) == 0 else 0  # the seeded offsets mask by B − 1
    for seed in (0, 2**31 + 3, 2**32 - 1)[:seeded]:
        v, o = randk.randk_seeded(x, seed, kb, B / kb)
        vr, orf = ref.randk_seeded_ref(x, seed, kb, B / kb)
        assert torch.equal(o, orf) and torch.equal(_bits(v), _bits(vr))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["randk_gather"] == 1
    assert kernels.launch_counts()["randk_seeded"] == seeded


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WIRE_SHAPES, ids=str)
def test_global_norm_qsgd_bit_equal_on_card(dev, shape, xdtype):
    nblk, B, _ = shape
    gen = torch.Generator(device=dev).manual_seed(8)
    x = (3 * torch.randn((nblk, B), generator=gen, device=dev)).to(xdtype)
    x[0] = 0.0
    u = torch.rand((nblk, B), generator=gen, device=dev)
    kernels.reset_launch_counts()
    sq = quantize.block_sumsq(x)
    assert torch.equal(_bits(sq), _bits(ref.block_sumsq_ref(x))) and float(sq[0]) == 0.0
    norm = torch.sqrt(torch.sum(sq.double())).float()
    for s in (1, 7, 15):
        # a zero norm (safe = 1) only at s = 1: s·|x| + u must fit int8
        for nv in (norm, torch.zeros_like(norm))[:2 if s == 1 else 1]:
            q = quantize.qsgd_quantize(x, u, nv, s)
            assert torch.equal(q, ref.qsgd_quantize_ref(x, u, nv, s))
            d = quantize.qsgd_dequantize(q, nv, s)
            assert torch.equal(_bits(d), _bits(ref.qsgd_dequantize_ref(q, nv, s)))
    assert int(quantize.qsgd_quantize(x, u, norm, 7).abs().max()) <= 7
    torch.cuda.synchronize()
    assert kernels.launch_counts()["block_sumsq"] == 1
    assert kernels.launch_counts()["qsgd_quantize"] == 5


def test_scatter_accum_refuses_a_row_past_shared_memory_on_card(dev):
    W = randk.MAX_SCATTER_WIDTH + 1
    v = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError, match=str(W)):
        randk.scatter_accum(v, torch.zeros((1, 2, 4), dtype=torch.int32, device=dev), W)


def test_flat_wire_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 256), device=dev)
    offs = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="power of two"):
        randk.randk_seeded(torch.zeros((4, 384), device=dev), 1, 8, 1.0)
    with pytest.raises(ValueError, match="int32"):
        randk.randk_gather(x, offs.long(), 1.0)
    with pytest.raises(ValueError, match="f32 or bf16"):
        randk.randk_seeded(x.double(), 1, 8, 1.0)
    with pytest.raises(ValueError, match="multiple of 128"):
        quantize.block_sumsq(torch.zeros((4, 64), device=dev))
    with pytest.raises(ValueError, match="one f32 value"):
        quantize.qsgd_quantize(x, x, torch.zeros(2, device=dev), 7)
    with pytest.raises(ValueError, match="int8"):
        quantize.qsgd_dequantize(x, torch.tensor(1.0, device=dev), 7)


def test_flat_wire_ops_on_card_match_plain_versions(dev):
    """``ops`` and the flat block primitives through the kernels against
    ``backend="ref"`` on the card, bit for bit."""
    from repro_torch import prng
    from repro_torch.core import flat
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(9)
    d = 5 * 1024 + 300
    x = torch.randn((d,), generator=gen, device=dev)
    key = prng.PRNGKey(3)
    for backend in ("auto", "cuda"):
        v, o = ops.randk_compress(x, key, 20, 1024, backend)
        vr, orf = ops.randk_compress(x, key, 20, 1024, "ref")
        assert torch.equal(o, orf) and torch.equal(v, vr)
        dense = ops.randk_decompress_mean(v[None], o[None], d, 1024, backend)
        assert torch.equal(dense, ops.randk_decompress_mean(vr[None], orf[None], d, 1024, "ref"))
        q, n = ops.qsgd_compress(x, key, 7, 1024, backend)
        qr, nr = ops.qsgd_compress(x, key, 7, 1024, "ref")
        assert torch.equal(q, qr) and torch.equal(n, nr)
        assert torch.equal(ops.qsgd_decompress(q, n, 7, d, 1024, backend),
                           ops.qsgd_decompress(qr, nr, 7, d, 1024, "ref"))
        x2d = ops.pad_to_blocks(x, 1024)
        bv, bo = flat.block_compress(x2d, 12345, 20, 51.2, backend)
        bvr, bor = flat.block_compress(x2d, 12345, 20, 51.2, "ref")
        assert torch.equal(bo, bor) and torch.equal(bv, bvr)
        assert torch.equal(flat.block_gather(x2d, bo, 51.2, backend), bv)


def test_moe_ff_is_run_to_run_identical_on_card(dev):
    """The MoE layer's combine is a gather in top-k order (no duplicate-index
    scatter-add), so two runs on the card give the same bits (ROADMAP C):
    reduced DeepSeek-V3's router (sigmoid, top-8 of 32) over 512 tokens,
    with drops (capacity factor 1)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe, reduced

    cfg = reduced(get_arch("deepseek-v3-671b").model, layers=4, d_model=256)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=32,
                                                           top_k=8, capacity_factor=1.0))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, dev)
    x = torch.randn((2, 256, 256), generator=gen, device=dev)
    drops = torch.zeros((), dtype=torch.long, device=dev)
    moe.moe_ff.drops = drops
    try:
        y1, a1 = moe.moe_ff(p, cfg, x)
        y2, a2 = moe.moe_ff(p, cfg, x)
    finally:
        moe.moe_ff.drops = None
    assert int(drops) > 0
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32)) and torch.equal(a1, a2)


# -- the memory counter (``roofline/memory.py``) on the card: the dry run's
#    small steps (``_torch_parity.memory_steps``: a reduced Qwen1.5-0.5B
#    train step, sync and compressed, the paged decode and prefill steps on
#    a stand-in of a (2, m) mesh) counted within the tolerance of the
#    caching allocator's peak, and counted on the card as on meta

def _counted(device, model):
    from _torch_parity import memory_steps
    from repro_torch.roofline import analyze_step

    return {name: analyze_step(fn, *args, arg_shares=shares,
                               device=device if device.type == "cuda" else None).to_dict()
            for name, (fn, args, shares, _b) in memory_steps(device, model).items()}


@pytest.mark.parametrize("model", [1, 2])
def test_memory_counter_within_tolerance_of_the_allocator_on_card(dev, model):
    from repro_torch.roofline.memory import against_allocator

    for name, entry in _counted(dev, model).items():
        cmp = against_allocator(entry)
        assert cmp is not None and cmp["within"], (name, cmp)
        assert entry["allocated_at_entry"] >= entry["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.parametrize("model", [1, 2])
def test_memory_counter_counts_on_card_as_on_meta(dev, model):
    card, meta = _counted(dev, model), _counted(torch.device("meta"), model)
    for name, entry in card.items():
        assert entry["memory_analysis"] == meta[name]["memory_analysis"], name
        assert entry["peak_memory_op"] == meta[name]["peak_memory_op"], name
