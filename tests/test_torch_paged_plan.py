"""The paged-attention kernel's launch plan, on the CPU.

``csrc/paged.cu`` serves each (slot, kv-head) pair with a cluster of C CTAs
that split the pages holding the slot's valid positions;
``kernels/paged.py::launch_plan`` picks C and the shared memory from the
static shape, and ``rank_pages`` / ``smem_bytes`` repeat the kernel's split
and layout (the kernel refuses a size that is not its own). Here, for every
instantiated (hd, rep, dtype) and the shapes the serve path, ``chip_smoke.py``
and the card tests give it: at every n_valid, every valid position is
covered by exactly one rank and no rank holds more than its logits' room,
and the layout fits the H100's 232,448 bytes. Then the kernel's order of
operations (rank-local logits, the cluster max, rank-order sums, weights
rounded to v's type, rank-order partial outputs), emulated in torch,
against the port's plain version and the JAX reference at the cluster
split's edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels import paged as jpaged
from repro_torch.kernels import paged, ref

#: (S, KV, P, max_pages): the serve shape and the GQA stress shape of
#: chip_smoke.py, the card tests' shapes, the cluster-edge geometries, one
#: page, a 32,768-position row, and the Llama-4-Scout / rep-7 decode shape of
#: chip_smoke.py's kernel phase (8 slots, KV = 8, 36 pages of 16)
SHAPES = [(8, 16, 16, 36), (64, 8, 16, 256), (3, 2, 4, 5), (5, 8, 16, 12), (2, 8, 8, 3),
          (3, 2, 4, 4), (9, 2, 4, 13), (9, 2, 16, 70), (1, 1, 16, 1), (1, 8, 16, 2048),
          (8, 8, 16, 36)]
INSTANCES = [(hd, rep, dt) for hd in paged.HEAD_DIMS for rep in paged.GROUPS
             for dt in (torch.float32, torch.bfloat16)]


def _n_values(P, maxp, C):
    """n_valid at the split's edges (1, a page boundary and one past it, C
    pages — each rank exactly one — and one past it, ≤ 0, L, past L) and
    every n of the first few pages."""
    L = maxp * P
    return sorted({1, P, P + 1, C * P, C * P + 1, 0, -3, L, L + 9, *range(1, min(L, 4 * P))})


@pytest.mark.parametrize("hd,rep,dtype", INSTANCES, ids=str)
def test_launch_plan_covers_every_position_once_within_shared_memory(hd, rep, dtype):
    elt = torch.tensor([], dtype=dtype).element_size()
    for S, KV, P, maxp in SHAPES:
        C, smem = paged.launch_plan(S, KV, hd, rep, P, maxp, elt)
        assert C in paged.CLUSTER_SIZES and C <= maxp
        L, ppr = maxp * P, -(-maxp // C)
        for n_valid in _n_values(P, maxp, C):
            n = L if n_valid <= 0 or n_valid > L else n_valid
            pages = paged.rank_pages(-(-n // P), C)
            assert len(pages) == C and pages[0][0] == 0 and pages[-1][1] == -(-n // P)
            assert all(a[1] == b[0] for a, b in zip(pages, pages[1:]))
            assert all(p1 - p0 <= ppr for p0, p1 in pages)  # the logits' room
            covered = np.zeros(L, np.int64)
            for p0, p1 in pages:
                covered[p0 * P:min(p1 * P, n)] += 1
            assert (covered[:n] == 1).all() and (covered[n:] == 0).all()
        assert smem == paged.smem_bytes(elt, hd, rep, P, maxp, C) <= paged.SMEM_LIMIT
        assert smem >= 4 * rep * ppr * P + paged.STAGES * paged.TILE * hd * elt
        # a smaller cluster would leave a rank too many positions, or the card unfilled
        if C > 1:
            assert (-(-maxp // (C // 2)) * P > paged.RANK_POSITIONS
                    or S * KV * C // 2 < paged.FILL_CTAS)
    # the shapes chip_smoke.py measures: 4 CTAs a row at the serve shape, 8 at
    # the GQA stress shape
    assert paged.launch_plan(8, 16, 64, 1, 16, 36, 4)[0] == 4
    assert paged.launch_plan(64, 8, 128, 8, 16, 256, elt)[0] == 8


def test_launch_plan_at_the_new_gqa_ratios():
    """Every rep of 1 … 8 is instantiated, and hd 256 or rep 9 is refused by
    the wrapper's shape check. At the Llama-4-Scout (rep 5) and rep-7
    decode shapes (8 slots, KV = 8, 36 pages of 16) a row splits over 8
    CTAs in both dtypes."""
    assert paged.GROUPS == tuple(range(1, 9))
    for rep in (5, 7):
        for elt in (4, 2):
            C, smem = paged.launch_plan(8, 8, 128, rep, 16, 36, elt)
            assert C == 8 and smem <= paged.SMEM_LIMIT
    tables = torch.zeros((1, 2), dtype=torch.int32)
    n_valid = torch.ones((1,), dtype=torch.int32)
    for H, KV, hd in ((9, 1, 64), (8, 8, 256)):
        q = torch.zeros((1, H, hd))
        pages = torch.zeros((3, 4, KV, hd))
        with pytest.raises(ValueError, match="must lie in"):
            paged.check_paged_shapes(q, pages, pages, tables, n_valid)


def test_launch_plan_refuses_rows_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        paged.launch_plan(1, 8, 128, 8, 16, 4096, 2)  # 65,536 positions, 8 heads
    # Qwen3-32B's 40,960 positions (hd 128, 8 heads a kv-head) fit in f32
    assert paged.launch_plan(1, 8, 128, 8, 16, 2560, 4)[1] <= paged.SMEM_LIMIT


def _cluster_emulation(q, kp, vp, tables, n_valid, C):
    """csrc/paged.cu's order of operations in torch: each rank's logits
    round_T(q·k)·scale, the max over the ranks, e = exp(l − m), the ranks'
    sums added in rank order, w = round_T(e / Σ), the ranks' f32 partial
    outputs added in rank order, rounded to T once."""
    S, H, hd = q.shape
    P, KV = kp.shape[1], kp.shape[2]
    maxp = tables.shape[1]
    L, rep, T = maxp * P, H // KV, q.dtype
    kf = ref.paged_gather_ref(kp, tables).float()
    vf = ref.paged_gather_ref(vp, tables).float()
    out = torch.empty((S, H, hd), dtype=T)
    for s in range(S):
        n = int(n_valid[s])
        masked = n <= 0
        n = L if masked or n > L else n
        for h in range(H):
            g = h // rep
            spans = [(p0 * P, min(p1 * P, n))
                     for p0, p1 in paged.rank_pages(-(-n // P), C)]
            lg = []
            for lo, hi in spans:
                t = torch.arange(lo, max(lo, hi))
                d = kf[s, t, g] @ q[s, h].float()
                lg.append(torch.full((len(t),), -1e30) if masked
                          else d.to(T).float() * ref.attn_scale(hd))
            m = max(float(x.max()) for x in lg if len(x))
            e = [torch.exp(x - m) for x in lg]
            tot = torch.tensor(0.0)
            for x in e:
                tot = tot + x.sum()
            acc = torch.zeros(hd)
            for (lo, hi), x in zip(spans, e):
                w = (x / tot).to(T).float()
                acc = acc + w @ vf[s, torch.arange(lo, max(lo, hi)), g]
            out[s, h] = acc.to(T)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("geom", [(2, 4, 13), (4, 16, 9)], ids=str)
def test_cluster_split_order_matches_plain_version_and_reference(dtype, geom):
    """At n_valid = 1 (every other rank empty), a page boundary, C pages
    (a split boundary: each rank one page) and one past it, 0 and −3
    (uniform over the row) and past L (clamped), with max_pages not a
    multiple of C."""
    KV, P, maxp = geom
    S, H, hd, rep = 9, 2 * KV, 32, 2
    C, _ = paged.launch_plan(S, KV, hd, rep, P, maxp, 4)
    assert C > 1 and maxp % C
    rng = np.random.default_rng(7)
    npage = 1 + S * maxp
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((npage, P, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((npage, P, KV, hd), dtype=np.float32)
    tables = (1 + rng.permutation(npage - 1)).astype(np.int32).reshape(S, maxp)
    L = maxp * P
    n_valid = np.array([1, P, C * P, C * P + 1, 0, -3, L, L + 9, P + 1], np.int32)
    _hold_emulation(q, kp, vp, tables, n_valid, C, dtype)


def _hold_emulation(q, kp, vp, tables, n_valid, C, dtype):
    """The emulation against the plain version (f32: |Δ| ≤ 1e-5·max|v|,
    bf16: one ulp of each output row's largest magnitude) and, in f32, the
    reference within rtol 1e-5."""
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, n_valid)]
    for i in range(3):
        t[i] = t[i].to(dtype)
    got = _cluster_emulation(*t, C)
    plain = paged.paged_attn_decode(*t)
    diff = (got.float() - plain.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(t[2].abs().max())
        want = np.asarray(jpaged.paged_attn_decode(*(jnp.asarray(a) for a in (
            q, kp, vp, tables, n_valid)), backend="ref"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:  # one bf16 ulp of each output row's largest magnitude (ROADMAP C)
        top = plain.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0**-126)
        assert bool((diff <= torch.exp2(torch.floor(torch.log2(top)) - 7)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rep", [3, 5, 6, 7])
def test_cluster_split_order_at_the_new_gqa_ratios(rep, dtype):
    """The same emulation and edges at the ratios that do not divide the
    f32 path's eight thread groups, held against the plain version and the
    reference as the ratios 1, 2, 4 and 8 are."""
    KV, P, maxp = 2, 4, 13
    S, H, hd = 9, rep * KV, 32
    C, _ = paged.launch_plan(S, KV, hd, rep, P, maxp, 4)
    assert C > 1 and maxp % C
    rng = np.random.default_rng(rep)
    npage = 1 + S * maxp
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    kp = rng.standard_normal((npage, P, KV, hd), dtype=np.float32)
    vp = rng.standard_normal((npage, P, KV, hd), dtype=np.float32)
    tables = (1 + rng.permutation(npage - 1)).astype(np.int32).reshape(S, maxp)
    L = maxp * P
    n_valid = np.array([1, P, C * P, C * P + 1, 0, -3, L, L + 9, P + 1], np.int32)
    _hold_emulation(q, kp, vp, tables, n_valid, C, dtype)
