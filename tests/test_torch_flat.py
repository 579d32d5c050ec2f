"""The port's flat layout and engine against ``repro.core.flat``.

* leaf order / offsets of the layout equal JAX's (``jax.tree.flatten`` sorts
  dict keys), checked on the full Qwen1.5-0.5B parameter tree from shapes
  alone (``jax.eval_shape`` / the ``meta`` device);
* pack → unpack is the identity, and packs bit-equal to the reference's;
* the engine's aggregate / fused round / fused sync equal the reference
  engine's ``ref`` backend on the same key and inputs, for the ``randk``
  and ``permk`` samplers, and so do the ``PermK`` compressor's per-worker
  payloads and the permk wire's bits;
* the ``qsgd`` sampler and the compressed downlink (``make_downlink``,
  ``fused_round(down=…)``, ``roundtrip_worker``) against the reference's
  engine: worker seeds bit-equal, and each dequantized output within the
  rounding bound of ``test_torch_quantize.py`` plus the exact effect of any
  level that flipped (the block norms differ by ≤ 5 ulp); inside the port,
  the fused bidirectional round equals its hand-made composition bit for
  bit and the downlink is unbiased; the wire accounting, ω and ``s`` checks
  of the packed wire equal the reference's;
* backend resolution and the device rules of the entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.core import BlockQSGD as JBlockQSGD
from repro.core import PermK as JPermK
from repro.core import flat as jflat
from repro.core.compressors import tree_compress_worker as j_tree_compress_worker
from repro.core import stepsize as jstepsize
from repro.core import wire as jwire
from repro.kernels import ref as jref
from repro.models import init_params as j_init_params
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import BlockQSGD, PermK, make_compressor
from repro_torch.core import flat as tflat
from repro_torch.core.compressors import tree_compress_worker, tree_decompress
from repro_torch.core import stepsize as tstepsize
from repro_torch.core import wire as twire
from repro_torch.core.tree_util import tree_leaves
from repro_torch.kernels import ref as tref
from repro_torch.models import init_params, param_count

RAGGED = {
    "w": np.arange(24.0, dtype=np.float32).reshape(4, 6),
    "b": np.arange(5.0, dtype=np.float32),
    "nested": {"s": np.float32(2.5), "v": np.arange(7.0, dtype=np.float32),
               "z": [np.ones((3, 3), np.float32), np.zeros((1,), np.float32)]},
}


def test_qwen_layout_offsets_equal_jax():
    jcfg = j_get_arch("qwen1.5-0.5b").model
    jshapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    jlay = jflat.make_layout(jshapes)
    tparams = init_params(0, get_arch("qwen1.5-0.5b").model, device="meta")
    tlay = tflat.make_layout(tparams)
    assert (tlay.d, tlay.nblk, tlay.block) == (jlay.d, jlay.nblk, jlay.block)
    assert tlay.d == param_count(tparams) == 463_987_712
    assert [(s.offset, s.size, s.shape) for s in tlay.slots] == [
        (s.offset, s.size, tuple(s.shape)) for s in jlay.slots]


@pytest.mark.parametrize("block", [128, 1024])
def test_pack_unpack_roundtrip_and_bit_equal_pack(block):
    jtree = jax.tree.map(jnp.asarray, RAGGED)
    ttree = params_from_jax(RAGGED, device="cpu")
    jlay, tlay = jflat.make_layout(jtree, block=block), tflat.make_layout(ttree, block=block)
    jbuf, tbuf = jflat.pack(jlay, jtree), tflat.pack(tlay, ttree)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    out = tflat.unpack(tlay, tbuf)
    for a, b in zip(tree_leaves(out), tree_leaves(ttree)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    stacked = jax.tree.map(lambda x: np.stack([x, 2 * x, -x]), RAGGED)
    np.testing.assert_array_equal(
        tflat.pack_stacked(tlay, params_from_jax(stacked, device="cpu")).numpy(),
        np.asarray(jflat.pack_stacked(jlay, jax.tree.map(jnp.asarray, stacked))))


def _engines(tree_np, kb=8, block=128):
    jeng = jflat.make_engine(jax.tree.map(jnp.asarray, tree_np), kb=kb, block=block,
                             backend="ref")
    teng = tflat.make_engine(params_from_jax(tree_np, device="cpu"), kb=kb,
                             block=block, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("n", [1, 4])
def test_fused_delta_equals_reference(n):
    rng = np.random.default_rng(n)
    tree = {"w": rng.standard_normal((11, 13), dtype=np.float32),
            "b": rng.standard_normal((200,), dtype=np.float32)}
    diffs = jax.tree.map(lambda x: np.stack([x * (i + 1) for i in range(n)]), tree)
    jeng, teng = _engines(tree)
    out_j = jeng.fused_delta(jax.random.PRNGKey(5), jax.tree.map(jnp.asarray, diffs), n)
    out_t = teng.fused_delta(prng.PRNGKey(5), params_from_jax(diffs, device="cpu"), n)
    for a, b in zip(tree_leaves(out_t), jax.tree.leaves(out_j)):
        assert ulp_diff(a, b) <= 1
    assert teng.payload_bits() == jeng.payload_bits() == 32.0 + 32.0 * 3 * 8


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_fused_round_and_sync_equal_reference(xdtype):
    n, nblk, B = 4, 5, 128
    rng = np.random.default_rng(7)
    bufs = rng.standard_normal((n, nblk, B), dtype=np.float32)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    x = np.asarray(jnp.asarray(rng.standard_normal((nblk, B), dtype=np.float32)).astype(xdtype))
    jeng, teng = _engines({"v": np.zeros((nblk * B,), np.float32)}, kb=16, block=B)
    key = jax.random.PRNGKey(3)
    jg, jx = jeng.fused_round(key, jnp.asarray(bufs), n, jnp.asarray(g), jnp.asarray(x), 0.05)
    tg, tx = teng.fused_round(prng.PRNGKey(3), torch.from_numpy(bufs), n,
                              torch.from_numpy(g), params_from_jax(x, device="cpu"), 0.05)
    assert ulp_diff(tg, jg) <= 1 and ulp_diff(tx, jx) <= 1
    jg, jx = jeng.fused_sync(jnp.asarray(bufs), jnp.asarray(x), 0.05)
    tg, tx = teng.fused_sync(torch.from_numpy(bufs), params_from_jax(x, device="cpu"),
                             0.05)
    assert ulp_diff(tg, jg) <= 1 and ulp_diff(tx, jx) <= 1


@pytest.mark.parametrize("nblk,kb", [(1, 1), (3, 8), (453_113, 20)])
def test_wire_bits_and_stepsize_equal_reference(nblk, kb):
    assert twire.seeded_randk_bits(nblk, kb) == jwire.seeded_randk_bits(nblk, kb)
    d = nblk * 1000 + 7
    assert twire.downlink_dense_bits(d) == jwire.downlink_dense_bits(d)
    assert twire.dense_f32_bits(d) == jwire.dense_f32_bits(d)
    for p in (0.01, 0.3, 1.0):
        args = (2.5, 1024 / kb, p, 4)
        assert tstepsize.marina_gamma(*args) == jstepsize.marina_gamma(*args)


def test_backend_resolution_and_device_rules():
    cpu = torch.zeros(1)
    assert tflat.resolve_backend("auto", cpu) == "ref"
    assert tflat.resolve_backend("ref", cpu) == "ref"
    with pytest.raises(ValueError):
        tflat.resolve_backend("cuda", cpu)  # kernels run only on the card
    with pytest.raises(ValueError):
        tflat.resolve_backend("pallas")
    tree = {"v": torch.zeros(300)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tflat.make_engine(tree)  # the default device is cuda: no quiet CPU
        with pytest.raises(RuntimeError):
            init_params(0, get_arch("qwen1.5-0.5b").model)
    with pytest.raises(ValueError):  # every reference sampler is ported
        tflat.make_engine(tree, device="cpu", sampler="topk")


def _permk_engines(nblk, B):
    tree = {"v": np.zeros((nblk * B - 5,), np.float32)}
    jeng = jflat.make_engine(jax.tree.map(jnp.asarray, tree), block=B,
                             backend="ref", sampler="permk")
    teng = tflat.make_engine(params_from_jax(tree, device="cpu"), block=B,
                             device="cpu", sampler="permk")
    return jeng, teng


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_permk_engine_aggregate_and_bits_equal_reference(n):
    nblk, B = 6, 128
    jeng, teng = _permk_engines(nblk, B)
    bufs = np.random.default_rng(n).standard_normal((n, nblk, B), dtype=np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(9), n)
    tkey = prng.fold_in(prng.PRNGKey(9), n)
    assert teng._shared_seed(tkey) == int(jeng._shared_seed(key))
    want = jeng.aggregate(key, jnp.asarray(bufs), n)
    got = teng.aggregate(tkey, torch.from_numpy(bufs), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert teng.payload_bits(n) == jeng.payload_bits(n) == twire.permk_bits(nblk * B, n)
    with pytest.raises(ValueError):
        teng.payload_bits()  # the share is B/n: no default n
    with pytest.raises(ValueError):
        teng.omega  # PermK's ω belongs to the collection


@pytest.mark.parametrize("rows", [[3, 1], [0], [2, 0, 3]], ids=str)
def test_permk_encode_rows_of_a_part_equals_reference_rows(rows, monkeypatch):
    """A rank that holds r < n rows encodes each row's share straight from
    its own r-row stack: the payload equals those rows of the reference's
    n-row uplink, and no n-row stack is built (``new_zeros`` unreached)."""
    n, nblk, B = 4, 6, 128
    jeng, teng = _permk_engines(nblk, B)
    bufs = np.random.default_rng(31).standard_normal((n, nblk, B), dtype=np.float32)
    key, tkey = jax.random.PRNGKey(12), prng.PRNGKey(12)
    jv, _ = jflat.block_permk_workers(jnp.asarray(bufs), jeng._shared_seed(key), "ref")

    def refuse(*args, **kwargs):
        raise AssertionError("encode_rows built a zero-filled stack")

    whole = teng.encode_rows(tkey, torch.from_numpy(bufs), range(n), n)["values"]
    monkeypatch.setattr(torch.Tensor, "new_zeros", refuse)
    pay = teng.encode_rows(tkey, torch.from_numpy(bufs[rows]), rows, n)
    np.testing.assert_array_equal(pay["values"].numpy(), np.asarray(jv)[rows])
    assert torch.equal(pay["values"], whole[rows])
    assert (pay["seeds"].numpy().view(np.uint32) == teng._shared_seed(tkey)).all()


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_permk_fused_round_equals_reference(xdtype):
    n, nblk, B = 4, 5, 128
    rng = np.random.default_rng(17)
    bufs = rng.standard_normal((n, nblk, B), dtype=np.float32)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    x = np.asarray(jnp.asarray(rng.standard_normal((nblk, B), dtype=np.float32)).astype(xdtype))
    jeng, teng = _permk_engines(nblk, B)
    jg, jx = jeng.fused_round(jax.random.PRNGKey(4), jnp.asarray(bufs), n,
                              jnp.asarray(g), jnp.asarray(x), 0.05)
    tg, tx = teng.fused_round(prng.PRNGKey(4), torch.from_numpy(bufs), n,
                              torch.from_numpy(g), params_from_jax(x, device="cpu"), 0.05)
    assert ulp_diff(tg, jg) <= 1 and ulp_diff(tx, jx) <= 1


@pytest.mark.parametrize("n", [2, 4])
def test_permk_compressor_equals_reference(n):
    """Per-worker payloads (values, seed) of the PermK collection on a ragged
    tree under one shared key, their decompression, the theory constants,
    and the single-operator view's uniform worker draw."""
    tree = {"w": np.random.default_rng(n).standard_normal((7, 30), dtype=np.float32),
            "b": np.random.default_rng(n + 1).standard_normal((333,), dtype=np.float32)}
    jc, tc = JPermK(n=n, block=128), PermK(n=n, block=128)
    ttree = params_from_jax(tree, device="cpu")
    key, tkey = jax.random.PRNGKey(21), prng.PRNGKey(21)
    for w in range(n):
        jp = j_tree_compress_worker(jc, key, jax.tree.map(jnp.asarray, tree), w)
        tp = tree_compress_worker(tc, tkey, ttree, w)
        for a, b in zip(tp.payloads, [jp[k] for k in sorted(tree)]):  # leaf order
            assert a["seed"] == int(b["seed"]) and a["wid"] == int(b["wid"]) == w
            np.testing.assert_array_equal(a["values"].numpy(), np.asarray(b["values"]))
        dense = tree_decompress(tc, tp, ttree)
        for k in tree:
            np.testing.assert_array_equal(
                dense[k].numpy(),
                np.asarray(jc.decompress(jp[k], tree[k].size)).reshape(tree[k].shape))
    d = 7 * 30
    assert (tc.omega(d), tc.expected_density(d), tc.payload_bits(d)) == (
        jc.omega(d), jc.expected_density(d), jc.payload_bits(d))
    assert tc.ab_constants(d, n) == jc.ab_constants(d, n) == (1.0, 1.0)
    x = torch.from_numpy(tree["b"])
    jpay = jc.compress(key, jnp.asarray(tree["b"]))
    tpay = tc.compress(tkey, x)
    assert tpay["wid"] == int(jpay["wid"]) and tpay["seed"] == int(jpay["seed"])
    np.testing.assert_array_equal(tpay["values"].numpy(), np.asarray(jpay["values"]))


# ---------------------------------------------------------------------------
# The packed QSGD wire and the compressed downlink
# ---------------------------------------------------------------------------

U = 2.0**-24
NORM_ULP = 5  # block norms: the port's fixed order vs XLA's (test_torch_quantize.py)


def _qsgd_engines(tree_np, s=7, block=128, sampler="qsgd", kb=8):
    jeng = jflat.make_engine(jax.tree.map(jnp.asarray, tree_np), kb=kb, block=block,
                             backend="ref", sampler=sampler, s=s)
    teng = tflat.make_engine(params_from_jax(tree_np, device="cpu"), kb=kb,
                             block=block, device="cpu", sampler=sampler, s=s)
    return jeng, teng


def _dequant_tolerance(t_levels, j_levels, j_norms, s):
    """How far the port's dequantized mean may sit from the reference's on
    the same inputs: the rounding bound of the two arithmetics plus the
    norms' ≤ NORM_ULP ulp, and at a coordinate where a level flipped, that
    flip's exact weight |Δlevel|·norm/(s·n)."""
    tl = t_levels.numpy().astype(np.float64)
    jl = np.asarray(j_levels).astype(np.float64)
    nm = np.asarray(j_norms).astype(np.float64)[..., None] / s
    n = tl.shape[0]
    rounding = (2 * (n + 3) + 2 * NORM_ULP) * U * (np.abs(jl) * nm).sum(0) / n
    flips = (np.abs(tl - jl) * nm).sum(0) / n * (1 + 2 * NORM_ULP * U)
    return rounding + flips, int((tl != jl).sum())


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_qsgd_engine_aggregate_and_fused_round_equal_reference(n, xdtype):
    tree = {"w": np.zeros((11, 13), np.float32), "b": np.zeros((300,), np.float32)}
    jeng, teng = _qsgd_engines(tree)
    nblk, B = teng.layout.nblk, teng.layout.block
    rng = np.random.default_rng(30 + n)
    bufs = rng.standard_normal((n, nblk, B), dtype=np.float32)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    x = np.asarray(jnp.asarray(rng.standard_normal((nblk, B), dtype=np.float32)).astype(xdtype))
    key, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11)
    seeds = np.asarray(jeng.worker_seeds(key, n))
    np.testing.assert_array_equal(teng.worker_seeds(tkey, n), seeds)

    jl, jn = jref.qsgd_block_workers_ref(jnp.asarray(bufs), jnp.asarray(seeds), 7)
    tl, tn = teng._qsgd_payloads(tkey, torch.from_numpy(bufs), n)
    assert ulp_diff(tn, jn) <= NORM_ULP
    tol, _ = _dequant_tolerance(tl, jl, jn, 7)
    got = teng.aggregate(tkey, torch.from_numpy(bufs), n).numpy().astype(np.float64)
    assert (np.abs(got - np.asarray(jeng.aggregate(key, jnp.asarray(bufs), n))) <= tol).all()

    jg, jx = jeng.fused_round(key, jnp.asarray(bufs), n, jnp.asarray(g), jnp.asarray(x), 0.05)
    tg, tx = teng.fused_round(tkey, torch.from_numpy(bufs), n, torch.from_numpy(g),
                              params_from_jax(x, device="cpu"), 0.05)
    tol_g = tol + np.spacing(np.abs(g) + 2 * np.asarray(jn).max())
    assert (np.abs(tg.numpy().astype(np.float64) - np.asarray(jg)) <= tol_g).all()
    _, jx_from_tg = jref.delta_epilogue_ref(jnp.zeros_like(jg), jnp.asarray(tg.numpy()),
                                            jnp.asarray(x), 0.05)
    assert ulp_diff(tx, jx_from_tg) <= 1
    assert teng.payload_bits() == jeng.payload_bits() == twire.block_qsgd_bits(nblk, B, 7)
    assert teng.omega == jeng.omega


def test_downlink_fused_round_equals_reference():
    """A RandK uplink with a QSGD downlink: the uplink's aggregate within 1
    ulp, the broadcast's n = 1 payload and the epilogue within the
    dequantization tolerance of the reference's bidirectional round."""
    n, tree = 3, {"v": np.zeros((640,), np.float32)}
    jeng, teng = _qsgd_engines(tree, sampler="randk")
    jdown = jflat.make_downlink(jeng, sampler="qsgd", s=7)
    tdown = tflat.make_downlink(teng, sampler="qsgd", s=7)
    assert (tdown.layout, tdown.device, tdown.kb) == (teng.layout, teng.device, teng.kb)
    nblk, B = teng.layout.nblk, teng.layout.block
    rng = np.random.default_rng(12)
    bufs = rng.standard_normal((n, nblk, B), dtype=np.float32)
    g = rng.standard_normal((nblk, B), dtype=np.float32)
    x = rng.standard_normal((nblk, B), dtype=np.float32)
    k_up, k_down = jax.random.split(jax.random.PRNGKey(9))
    tk_up, tk_down = prng.split(prng.PRNGKey(9))
    jg, jx = jeng.fused_round(k_up, jnp.asarray(bufs), n, jnp.asarray(g), jnp.asarray(x),
                              0.05, down=jdown, down_key=k_down)
    tg, tx = teng.fused_round(tk_up, torch.from_numpy(bufs), n, torch.from_numpy(g),
                              torch.from_numpy(x), 0.05, down=tdown, down_key=tk_down)
    j_up = jeng.aggregate(k_up, jnp.asarray(bufs), n)
    t_up = teng.aggregate(tk_up, torch.from_numpy(bufs), n)
    assert ulp_diff(t_up, j_up) <= 1
    jl, jn = jref.qsgd_block_workers_ref(j_up[None], jdown.worker_seeds(k_down, 1), 7)
    tl, _ = tdown._qsgd_payloads(tk_down, t_up[None], 1)
    tol, _ = _dequant_tolerance(tl, jl, jn, 7)
    tol_g = tol + np.spacing(np.abs(g) + 2 * np.asarray(jn).max())
    assert (np.abs(tg.numpy().astype(np.float64) - np.asarray(jg)) <= tol_g).all()
    _, jx_from_tg = jref.delta_epilogue_ref(jnp.zeros_like(jg), jnp.asarray(tg.numpy()),
                                            jnp.asarray(x), 0.05)
    assert ulp_diff(tx, jx_from_tg) <= 1
    assert tdown.payload_bits(1) == jdown.payload_bits(1) == twire.block_qsgd_bits(nblk, B, 7)


def test_fused_bidirectional_round_equals_manual_composition():
    """fused_round(down=…) == aggregate → Q_down (qsgd, n = 1, through the
    nibble words) → g + δ → x − γ·g assembled from the plain versions, bit
    for bit; a PermK downlink and a foreign layout are refused."""
    n, tree = 3, {"v": np.zeros((256,), np.float32)}
    _, eng = _qsgd_engines(tree, sampler="randk")
    down = tflat.make_downlink(eng, sampler="qsgd", s=7)
    lay = eng.layout
    rng = np.random.default_rng(6)
    diffs, g2d, x2d = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                       for shape in ((n, lay.nblk, lay.block), (lay.nblk, lay.block),
                                     (lay.nblk, lay.block)))
    k_up, k_down = prng.split(prng.PRNGKey(9))
    g_new, x_new = eng.fused_round(k_up, diffs, n, g2d, x2d, 0.05, down=down,
                                   down_key=k_down)
    delta_up = eng.aggregate(k_up, diffs, n)
    seeds = torch.from_numpy(down.worker_seeds(k_down, 1).view(np.int32))
    levels, norms = tref.qsgd_block_workers_ref(delta_up[None], seeds, 7)
    levels = tref.nibble_unpack_ref(tref.nibble_pack_ref(levels[0]), lay.block)[None]
    g_ref = g2d + tref.qsgd_dequant_mean_ref(levels, norms, 7)
    x_ref = torch.tensor(-0.05) * g_ref + x2d
    assert torch.equal(g_new, g_ref) and torch.equal(x_new, x_ref)
    with pytest.raises(ValueError, match="PermK"):
        eng.fused_round(k_up, diffs, n, g2d, x2d, 0.05,
                        down=tflat.make_downlink(eng, sampler="permk"), down_key=k_down)
    other = tflat.make_engine({"v": torch.zeros(1000)}, block=128, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        eng.fused_round(k_up, diffs, n, g2d, x2d, 0.05, down=other, down_key=k_down)


def test_downlink_roundtrip_unbiased():
    """E[Q_down(δ)] ≈ δ over keys for the qsgd downlink engine: the
    broadcast keeps the estimator recursion mean-correct."""
    _, eng = _qsgd_engines({"v": np.zeros((256,), np.float32)}, sampler="randk")
    down = tflat.make_downlink(eng, sampler="qsgd", s=7)
    delta = torch.from_numpy(np.random.default_rng(4).standard_normal(256, dtype=np.float32))
    trials = 2000
    keys = prng.split(prng.PRNGKey(5), trials)
    mean = sum(down.roundtrip_worker(k, {"v": delta})["v"] for k in keys) / trials
    rel = float(torch.linalg.norm(mean - delta) / torch.linalg.norm(delta))
    # ω(block qsgd, s = 7) = min(B/49, √B/7) ≈ 1.6 at B = 128
    assert rel < 3.0 * np.sqrt(1.7 / trials)


def test_qsgd_wire_accounting_and_omega_equal_reference():
    """Compressor, engine and wire helpers book the same packed bits (nibble
    wire for s ≤ 7, int8 above), ω routes by sampler, the bits-balanced p,
    and an s beyond int8 is refused — all as in the reference."""
    d, B, nblk = 2000, 1024, 2
    tree_np = {"w": np.ones((d,), np.float32)}
    for s, bits_per in ((7, 4.0), (15, 8.0), (127, 8.0)):
        tc, jc = make_compressor("block_qsgd", s=s, block=B), JBlockQSGD(s=s, block=B)
        jeng, teng = _qsgd_engines(tree_np, s=s, block=B)
        want = 32.0 * nblk + bits_per * nblk * B
        assert tc.payload_bits(d) == jc.payload_bits(d) == want == teng.payload_bits()
        assert jeng.payload_bits() == twire.block_qsgd_bits(nblk, B, s) == want
        assert (tc.omega(d), tc.expected_density(d), tc.default_p(d)) == (
            jc.omega(d), jc.expected_density(d), jc.default_p(d))
        assert teng.omega == jeng.omega == min(B / s**2, np.sqrt(B) / s)
    assert abs(BlockQSGD(s=7, block=B).default_p(B * nblk)
               - (32.0 * nblk + 4.0 * nblk * B) / (32.0 * nblk * B)) < 1e-12
    with pytest.raises(ValueError):
        tflat.make_engine({"w": torch.ones(d)}, block=B, sampler="qsgd", s=200,
                          device="cpu")
    with pytest.raises(ValueError):
        BlockQSGD(s=0)


def test_block_qsgd_compressor_equals_reference():
    """The tree path's payload: norms within NORM_ULP, levels through the
    nibble words equal the reference's where no level flipped (counted),
    and decompression within the dequantization tolerance."""
    x = np.random.default_rng(8).standard_normal(700, dtype=np.float32)
    jc, tc = JBlockQSGD(s=7, block=128), BlockQSGD(s=7, block=128)
    jp = jc.compress(jax.random.PRNGKey(2), jnp.asarray(x))
    tp = tc.compress(prng.PRNGKey(2), torch.from_numpy(x))
    assert ulp_diff(tp["norms"], jp["norms"]) <= NORM_ULP
    flips = int((tp["q"].numpy() != np.asarray(jp["q"])).sum())
    assert flips <= 2
    tol, _ = _dequant_tolerance(tp["q"][None], jp["q"][None], jp["norms"][None], 7)
    got = tc.decompress(tp, 700).numpy().astype(np.float64)
    assert (np.abs(got - np.asarray(jc.decompress(jp, 700))) <= tol.reshape(-1)[:700]).all()
