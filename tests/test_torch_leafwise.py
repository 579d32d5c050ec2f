"""The per-leaf wire remainder of the port against the reference: the
``SharedRandK`` and ``CorrelatedQ`` compressors, ``Compressor.ab_constants``,
``tree_roundtrip`` and ``tree_ab_constants``, and the per-leaf compressed
downlink (``down_compressor``) of MARINA, VR-MARINA and PP-MARINA and of the
trainer.

Tolerances (ROADMAP C):

* SharedRandK's indices and values are bit-equal (one key for every worker).
* CorrelatedQ's dithers are bit-equal to the reference's eager ones; under
  ``jit`` XLA multiplies (wid + r) by f32(1/n) instead of dividing by n:
  the same for n a power of two, within 1 ulp for n = 3. Its levels are
  bit-equal given the reference's norm; the norm (a sum of squares in
  another order) within 5 ulp.
* Trajectories under a non-quantizing per-leaf downlink (RandK) run free at
  the binclass tolerance, rtol 1e-5. Under a per-leaf QSGD downlink they are
  held round by round from the reference's state, and a level may flip where
  the norm's ulps carry the floor argument across an integer: flagged
  coordinates lie within one quantization step and number at most 1e-3 of
  all (binclass), or the LM's leafwise 1e-4 of the leaf's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro import core as jcore
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro_torch import core as tcore
from repro_torch import prng
from repro_torch.convert import state_from_jax
from repro_torch.core import (
    BlockRandK,
    CorrelatedQ,
    Marina,
    PPMarina,
    RandK,
    SharedRandK,
    VRMarina,
    make_compressor,
    make_engine,
    tree_ab_constants,
    tree_payload_bits,
    tree_roundtrip,
)
from repro_torch.core import compressors as tcomp
from repro_torch.core.problems import binclass_grad
from repro_torch.core.tree_util import tree_leaves
from repro_torch.models import init_params
from repro_torch.train import TrainConfig, Trainer
from test_torch_marina import (  # noqa: F401  (the binclass fixture and helpers)
    D,
    FLIP_SHARE,
    ROUNDS,
    _close_except_flips,
    _g_vec,
    _minibatch,
    _run_both,
    data,
)
from test_torch_models import (  # noqa: F401  (the small LM's fixtures and helpers)
    TCFG,
    _jgrad,
    _leaf_close_except_flips,
    _np_tree,
    _tgrad,
    jparams,
    mb_tokens,
    tokens,
    tokens4,
)


def test_core_exports_every_reference_name():
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert all(hasattr(tcore, name) for name in tcore.__all__)


# ---------------------------------------------------------------------------
# SharedRandK, CorrelatedQ and the AB constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,k", [(64, 8), (1000, 0.05), (513, 1)])
def test_shared_randk_matches_reference(d, k):
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    jc, tc = jcore.SharedRandK(k=k), make_compressor("shared_randk", k=k)
    assert isinstance(tc, SharedRandK) and tc.name == jc.name == "shared_randk"
    for seed in (0, 9):
        jp = jc.compress(jax.random.PRNGKey(seed), jnp.asarray(x))
        tp = tc.compress(prng.PRNGKey(seed), torch.from_numpy(x))
        np.testing.assert_array_equal(tp["indices"].numpy(), np.asarray(jp["indices"]))
        np.testing.assert_array_equal(tp["values"].numpy(), np.asarray(jp["values"]))
        np.testing.assert_array_equal(tc.decompress(tp, d).numpy(),
                                      np.asarray(jc.decompress(jp, d)))
    for n in (1, 4, 7):
        assert tc.ab_constants(d, n) == jc.ab_constants(d, n) == (tc.omega(d), 0.0)


def _reference_dither(key, shape, wid, n, jit):
    """The reference's stratified dither u = frac(v + (wid + r)/n), eager or
    under ``jit``."""
    def dither(key):
        k_v, k_r = jax.random.split(key)
        v = jax.random.uniform(k_v, shape)
        r = jax.random.randint(k_r, shape, 0, n)
        return jnp.mod(v + (jnp.asarray(wid, jnp.float32) + r) / n, 1.0)
    return np.asarray(jax.jit(dither)(key) if jit else dither(key))


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("s", [1, 4, 7])
def test_correlated_q_matches_reference(n, s):
    d = 300
    x = (np.random.default_rng(n * s).standard_normal(d) * 2).astype(np.float32)
    jc, tc = jcore.CorrelatedQ(s=s, n=n), make_compressor("correlated_qsgd", s=s, n=n)
    assert isinstance(tc, CorrelatedQ)
    for name in ("correlated_q", "cqsgd"):
        assert make_compressor(name, s=s, n=n) == tc
    assert tc.omega(d) == jc.omega(d) and tc.payload_bits(d) == jc.payload_bits(d)
    assert tc.ab_constants(d, n) == jc.ab_constants(d, n)
    for seed in (1, 2):
        key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        for wid in range(n):
            jp = jc.compress_worker(jkey, jnp.asarray(x), wid)  # eager: a true division
            tp = tc.compress_worker(key, torch.from_numpy(x), wid)
            assert ulp_diff(tp["norm"].reshape(1), np.asarray(jp["norm"]).reshape(1)) <= 5
            given = tc.quantize_worker(key, torch.from_numpy(x), wid,
                                       torch.tensor(np.asarray(jp["norm"])))
            np.testing.assert_array_equal(given.numpy(), np.asarray(jp["q"]))
            # the dithers: eager bit-equal; jit multiplies by 1/n
            k_v, k_r = prng.split(key)
            v = prng.uniform(k_v, (d,), device="cpu")
            r = prng.randint(k_r, (d,), 0, n, device="cpu").float()
            u = torch.remainder(v + (wid + r) / torch.tensor(float(n)), 1.0).numpy()
            np.testing.assert_array_equal(u, _reference_dither(jkey, (d,), wid, n, False))
            assert ulp_diff(u, _reference_dither(jkey, (d,), wid, n, True)) <= (
                0 if n == 4 else 1)
            np.testing.assert_allclose(tc.decompress(tp, d).numpy(),
                                       np.asarray(jc.decompress(jp, d)), rtol=1e-5,
                                       atol=float(jp["norm"]) / s)


@pytest.mark.parametrize("name,kw", [("randk", {"k": 8}), ("block_randk", {"kb": 8, "block": 128}),
                                     ("qsgd", {"s": 4}), ("natural", {}),
                                     ("block_qsgd", {"s": 7, "block": 128}),
                                     ("permk", {"n": 4, "block": 128}),
                                     ("shared_randk", {"k": 8}),
                                     ("correlated_qsgd", {"s": 4, "n": 4})])
def test_ab_constants_match_reference(name, kw):
    jc, tc = jcore.make_compressor(name, **kw), make_compressor(name, **kw)
    tree_t = {"a": torch.zeros(300), "b": torch.zeros((4, 128))}
    tree_j = {"a": jnp.zeros(300), "b": jnp.zeros((4, 128))}
    for d, n in ((512, 4), (300, 4)):
        assert tc.ab_constants(d, n) == jc.ab_constants(d, n)
    assert tree_ab_constants(tc, tree_t, 4) == jcore.tree_ab_constants(jc, tree_j, 4)


@pytest.mark.parametrize("name,kw", [("randk", {"k": 0.1}), ("block_randk", {"kb": 8, "block": 128}),
                                     ("shared_randk", {"k": 16})])
def test_tree_roundtrip_matches_reference(name, kw):
    rng = np.random.default_rng(5)
    leaves = {"a": rng.standard_normal(300).astype(np.float32),
              "b": rng.standard_normal((4, 128)).astype(np.float32)}
    jc, tc = jcore.make_compressor(name, **kw), make_compressor(name, **kw)
    jout = jcore.tree_roundtrip(jc, jax.random.PRNGKey(3),
                                {k: jnp.asarray(v) for k, v in leaves.items()})
    tout = tree_roundtrip(tc, prng.PRNGKey(3), {k: torch.from_numpy(v) for k, v in leaves.items()})
    for k in leaves:
        assert tout[k].shape == leaves[k].shape
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))


# ---------------------------------------------------------------------------
# MARINA-family trajectories: SharedRandK, CorrelatedQ, per-leaf downlinks
# ---------------------------------------------------------------------------


def _optimizers(method, jc, tc, carry, jdown=None, tdown=None, engines=(None, None)):
    jg = jax.grad(j_loss)
    jkw = dict(gamma=0.5, p=0.3, engine=engines[0], carry=carry, down_compressor=jdown)
    tkw = dict(gamma=0.5, p=0.3, engine=engines[1], carry=carry, down_compressor=tdown)
    if method == "marina":
        return jcore.Marina(jg, jc, **jkw), Marina(binclass_grad, tc, **tkw)
    if method == "vr_marina":
        return (jcore.VRMarina(jg, jg, jc, **jkw),
                VRMarina(binclass_grad, binclass_grad, tc, **tkw))
    return jcore.PPMarina(jg, jc, r=2, **jkw), PPMarina(binclass_grad, tc, r=2, **tkw)


def _step_args(method, jdata, tdata):
    if method == "vr_marina":
        return (lambda k: (jdata, _minibatch(jdata, k))), (lambda k: (tdata, _minibatch(tdata, k)))
    return (lambda k: (jdata,)), (lambda k: (tdata,))


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_marina_shared_randk_trajectory_equals_reference(data, carry):
    jdata, tdata = data
    jm, tm = _optimizers("marina", jcore.SharedRandK(k=16), SharedRandK(k=16), carry)
    _run_both(jm, tm, jdata, tdata, lambda k: (jdata,), lambda k: (tdata,))


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("method", ["marina", "vr_marina", "pp_marina"])
def test_per_leaf_randk_downlink_trajectory_equals_reference(data, method, carry):
    """A RandK broadcast per leaf (no quantization): free runs at rtol 1e-5,
    the down ledger ``tree_payload_bits`` of the downlink."""
    jdata, tdata = data
    jm, tm = _optimizers(method, jcore.BlockRandK(kb=8, block=128),
                         BlockRandK(kb=8, block=128), carry,
                         jcore.RandK(k=64), RandK(k=64))
    jargs, targs = _step_args(method, jdata, tdata)
    _run_both(jm, tm, jdata, tdata, jargs, targs)
    st = tm.init(torch.zeros(D), tdata)
    for k in range(4):
        st, met = tm.step(st, prng.PRNGKey(100 + k), *targs(k))
        want = 32.0 * D if met.sync_round else tree_payload_bits(RandK(k=64), st.params)
        assert met.down_bits == want


def _round_by_round(jm, tm, jargs, targs, steps):
    """ROUNDS rounds from the reference's state each time: c_k, both ledgers
    and the oracle count equal; params and g within rtol 1e-5 except at
    flagged coordinates within one quantization step (``steps`` collects the
    port's round's quantization steps)."""
    js = jm.init(jnp.zeros((D,)), jargs(0)[0])
    jstep = jax.jit(jm.step)
    kinds, flagged, compared = set(), 0, 0
    for k in range(ROUNDS):
        ts = state_from_jax(np.asarray(js.params), np.asarray(js.g), k,
                            None if js.h is None else np.asarray(js.h), device="cpu")
        steps.clear()
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *jargs(k))
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *targs(k))
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits, tmet.oracle_calls) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits),
            float(jmet.oracle_calls))
        kinds.add(tmet.sync_round)
        step = sum(steps)
        flagged += _close_except_flips(ts.params.numpy(), js.params, 0.5 * step)
        flagged += _close_except_flips(_g_vec(ts.g), _g_vec(js.g), step)
        compared += 2 * D
    assert kinds == {0, 1}
    assert flagged <= FLIP_SHARE * compared


def _record_steps(monkeypatch, cls, per_payload):
    """Record one quantization step per payload ``cls`` compresses."""
    steps = []
    compress = cls.compress_worker if per_payload == "worker" else cls.compress

    if per_payload == "worker":
        def recording(self, key, x, wid):
            p = compress(self, key, x, wid)
            steps.append(float(p["norm"]) / (self.s * self._n()))
            return p
        monkeypatch.setattr(cls, "compress_worker", recording)
    else:
        def recording(self, key, x):
            p = compress(self, key, x)
            steps.append(float(p["norm"]) / self.s)
            return p
        monkeypatch.setattr(cls, "compress", recording)
    return steps


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("method", ["marina", "vr_marina", "pp_marina"])
def test_per_leaf_qsgd_downlink_rounds_match_reference(data, method, carry, monkeypatch):
    jdata, tdata = data
    jm, tm = _optimizers(method, jcore.BlockRandK(kb=8, block=128),
                         BlockRandK(kb=8, block=128), carry, jcore.QSGD(s=7),
                         make_compressor("qsgd", s=7))
    steps = _record_steps(monkeypatch, tcomp.QSGD, "payload")
    _round_by_round(jm, tm, *_step_args(method, jdata, tdata), steps)


def test_per_leaf_downlink_beside_an_engine_in_recompute_rounds(data, monkeypatch):
    """The engine's RandK uplink with a per-leaf QSGD broadcast (recompute
    rounds: the epilogue kernel is not in the way)."""
    jdata, tdata = data
    engines = (j_make_engine(jnp.zeros((D,)), kb=8, block=128, backend="ref"),
               make_engine(torch.zeros(D), kb=8, block=128, device="cpu"))
    jm, tm = _optimizers("marina", jcore.BlockRandK(kb=8, block=128),
                         BlockRandK(kb=8, block=128), False, jcore.QSGD(s=7),
                         make_compressor("qsgd", s=7), engines)
    steps = _record_steps(monkeypatch, tcomp.QSGD, "payload")
    _round_by_round(jm, tm, lambda k: (jdata,), lambda k: (tdata,), steps)


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_marina_correlated_q_rounds_match_reference(data, carry, monkeypatch):
    """n = 4 (1/n exact, so the reference's jitted dither is its eager one)."""
    jdata, tdata = data
    jm, tm = _optimizers("marina", jcore.CorrelatedQ(s=4, n=4), CorrelatedQ(s=4, n=4),
                         carry)
    steps = _record_steps(monkeypatch, CorrelatedQ, "worker")
    _round_by_round(jm, tm, lambda k: (jdata,), lambda k: (tdata,), steps)


# ---------------------------------------------------------------------------
# the small LM and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["marina", "vr_marina", "pp_marina"])
def test_lm_per_leaf_qsgd_downlink_carry_rounds_match_reference(jparams, tokens, mb_tokens,
                                                                tokens4, method, monkeypatch):
    """5 carry rounds of the tree path (BlockRandK per leaf) under a per-leaf
    QSGD broadcast (s = 7), each from the reference's state: c_k and both
    ledgers equal; params and g leafwise within 1e-4 of the leaf's scale
    except at flagged coordinates within one quantization step (γ times it
    for params), at most 1e-3 of all."""
    gamma, jc, tc = 0.05, jcore.BlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)
    kw = dict(gamma=gamma, p=0.4, carry=True)
    toks = tokens4 if method == "pp_marina" else tokens
    if method == "marina":
        jm = jcore.Marina(_jgrad, jc, down_compressor=jcore.QSGD(s=7), **kw)
        tm = Marina(_tgrad, tc, down_compressor=make_compressor("qsgd", s=7), **kw)
    elif method == "vr_marina":
        jm = jcore.VRMarina(_jgrad, _jgrad, jc, down_compressor=jcore.QSGD(s=7), **kw)
        tm = VRMarina(_tgrad, _tgrad, tc, down_compressor=make_compressor("qsgd", s=7), **kw)
    else:
        jm = jcore.PPMarina(_jgrad, jc, r=2, down_compressor=jcore.QSGD(s=7), **kw)
        tm = PPMarina(_tgrad, tc, r=2, down_compressor=make_compressor("qsgd", s=7), **kw)
    steps = _record_steps(monkeypatch, tcomp.QSGD, "payload")

    def args(k, wrap):
        extra = (mb_tokens[k + 1],) if method == "vr_marina" else ()
        return tuple({"tokens": wrap(t)} for t in (toks[k + 1], *extra))

    js = jax.jit(jm.init)(jparams, {"tokens": jnp.asarray(toks[0])})
    jstep = jax.jit(jm.step)
    kinds, flagged, compared = set(), 0, 0
    for k in range(5):
        ts = state_from_jax(_np_tree(js.params), _np_tree(js.g), k, _np_tree(js.h),
                            device="cpu")
        steps.clear()
        key = jax.random.fold_in(jax.random.PRNGKey(7), k)
        js, jmet = jstep(js, key, *args(k, jnp.asarray))
        ts, tmet = tm.step(ts, prng.fold_in(prng.PRNGKey(7), k), *args(k, torch.tensor))
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits))
        kinds.add(tmet.sync_round)
        step = max(steps, default=0.0)  # one payload per leaf: the largest step
        for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(js.params)):
            flagged += _leaf_close_except_flips(a, b, 1e-4, gamma * step)
            compared += a.numel()
        for a, b in zip(tree_leaves(ts.g), jax.tree.leaves(js.g)):
            flagged += _leaf_close_except_flips(a, b, 1e-4, step)
            compared += a.numel()
    assert kinds == {0, 1}
    assert flagged <= 1e-3 * compared


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_trainer_per_leaf_downlink_cpu_smoke_and_ledger(carry):
    """Without a flat engine the trainer's downlink is the named per-leaf
    compressor: 4 steps, finite loss, the down ledger its
    ``tree_payload_bits`` on compressed rounds, 32·d on sync rounds."""
    params = init_params(0, TCFG, device="cpu")
    tc = TrainConfig(method="marina", compressor="randk", comp_kwargs={"k": 0.05},
                     gamma=0.05, p=0.5, batch_per_worker=2, steps=4, log_every=2,
                     n_workers=2, carry_grads=carry, downlink="qsgd",
                     downlink_kwargs={"s": 7})
    tr = Trainer(TCFG, tc, params, device="cpu")
    assert tr.engine is None and tr.down_engine is None
    _, hist = tr.run()
    d = sum(t.numel() for t in tree_leaves(params))
    down_q = tree_payload_bits(make_compressor("qsgd", s=7), params)
    assert all(np.isfinite(hist.loss)) and set(hist.round_sync) == {0, 1}
    for c_k, down in zip(hist.round_sync, hist.round_down_bits):
        assert down == (32.0 * d if c_k else down_q)
