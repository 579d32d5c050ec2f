"""The port's flat layout and engine against ``repro.core.flat``.

* leaf order / offsets of the layout equal JAX's (``jax.tree.flatten`` sorts
  dict keys), checked on the full Qwen1.5-0.5B parameter tree from shapes
  alone (``jax.eval_shape`` / the ``meta`` device);
* pack → unpack is the identity, and packs bit-equal to the reference's;
* the engine's aggregate / fused round / fused sync equal the reference
  engine's ``ref`` backend on the same key and inputs, for the ``randk``
  and ``permk`` samplers, and so do the ``PermK`` compressor's per-worker
  payloads and the permk wire's bits;
* backend resolution and the device rules of the entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ulp_diff
from repro.configs import get_arch as j_get_arch
from repro.core import PermK as JPermK
from repro.core import flat as jflat
from repro.core.compressors import tree_compress_worker as j_tree_compress_worker
from repro.core import stepsize as jstepsize
from repro.core import wire as jwire
from repro.models import init_params as j_init_params
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import PermK
from repro_torch.core import flat as tflat
from repro_torch.core.compressors import tree_compress_worker, tree_decompress
from repro_torch.core import stepsize as tstepsize
from repro_torch.core import wire as twire
from repro_torch.core.tree_util import tree_leaves
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
    with pytest.raises(NotImplementedError):
        tflat.make_engine(tree, device="cpu", sampler="qsgd")


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
