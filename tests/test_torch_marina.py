"""MARINA, VR-MARINA and PP-MARINA trajectories of the port against the
reference under the same keys.

On the eq. (11) binclass problem (n=4, d=512, B=128, kb=8), 20 rounds from
the same data, start point and per-round keys: the ``c_k`` sequence, the
bits ledger and the oracle count must be equal, params and the estimator g
must agree to rtol 1e-5 (torch and XLA reduce the gradient's matmuls in
different orders; the kernels themselves keep 1 ulp). Covered, in
recompute and carry rounds:

* ``Marina``: the flat engine, and the per-leaf tree path with RandK and
  BlockRandK;
* ``VRMarina`` (minibatches of 8 rows that move every round): the engine
  with the block_randk and permk wires, the tree path with RandK and PermK;
* ``PPMarina`` (r = 2 of 4): engine and tree path, cohorts with and without
  replacement, and with client weights.

The packed QSGD wire (``block_qsgd``, s = 7) and the compressed downlink (a
RandK uplink with a QSGD broadcast) quantize with a floor, so a level flips
wherever the gradients' rtol-1e-5 noise or the norms' ≤ 5 ulp carry the
floor argument across an integer, and a flip, once made, moves every later
round. These wires are therefore held round by round from the reference's
state (carried across by ``convert.state_from_jax``) for all three
optimizers in both round shapes: c_k, the up and down ledgers and the
oracle count equal; params and g within rtol 1e-5 / atol 1e-6 except at
flagged coordinates, which must lie within one quantization step
(Σ over the round's QSGD payloads of max norm / (s·n), times γ for params)
and number at most ``FLIP_SHARE`` of all. Run free, MARINA on both wires
keeps c_k and the ledgers equal and ends within rtol 1e-4 of the
reference's loss. Inside the port, the tree path of ``BlockQSGD`` equals
the flat engine bit for bit, bf16 parameters survive packed rounds, and the
downlink's refusals and ledgers mirror ``tests/test_roundstep.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core import BlockQSGD as JBlockQSGD
from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core import PermK as JPermK
from repro.core import PPMarina as JPPMarina
from repro.core import RandK as JRandK
from repro.core import VRMarina as JVRMarina
from repro.core.flat import make_downlink as j_make_downlink
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import binclass_smoothness as j_smoothness
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro_torch import prng
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import flat as tflat
from repro_torch.core import wire
from repro_torch.core import (
    BlockQSGD,
    BlockRandK,
    Marina,
    PermK,
    PPMarina,
    RandK,
    VRMarina,
    make_downlink,
    make_engine,
)
from repro_torch.core.problems import (
    binclass_grad,
    binclass_smoothness,
    make_synthetic_binclass,
)

N, M, D = 4, 32, 512
ROUNDS = 20


@pytest.fixture(scope="module")
def data():
    jdata = j_make_binclass(jax.random.PRNGKey(0), N, M, D)
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def _pair(kind, carry):
    if kind == "engine":
        jc, tc = JBlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)
        jeng = j_make_engine(jnp.zeros((D,)), kb=8, block=128, backend="ref")
        teng = make_engine(torch.zeros(D), kb=8, block=128, device="cpu")
    else:
        jc, tc = {"randk": (JRandK(k=16), RandK(k=16)),
                  "block_randk": (JBlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)),
                  }[kind]
        jeng = teng = None
    jm = JMarina(jax.grad(j_loss), jc, gamma=0.5, p=0.3, engine=jeng, carry=carry)
    tm = Marina(binclass_grad, tc, gamma=0.5, p=0.3, engine=teng, carry=carry)
    return jm, tm


def _g_vec(g):
    return np.asarray(g).reshape(-1)[:D]


def _run_both(jm, tm, jinit, tinit, jargs, targs):
    """ROUNDS rounds of both packages from x0 = 0 under keys 100 + k; round
    k's step arguments are ``jargs(k)`` / ``targs(k)``."""
    x0 = np.zeros((D,), np.float32)
    js = jm.init(jnp.asarray(x0), jinit)
    ts = tm.init(torch.from_numpy(x0), tinit)
    jstep = jax.jit(jm.step)
    kinds = set()
    for k in range(ROUNDS):
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *jargs(k))
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *targs(k))
        assert tmet.sync_round == int(jmet.sync_round)
        assert tmet.bits_per_worker == float(jmet.bits_per_worker)
        assert tmet.oracle_calls == float(jmet.oracle_calls)
        kinds.add(tmet.sync_round)
        np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_g_vec(ts.g), _g_vec(js.g), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tmet.grad_est_norm),
                                   float(jmet.grad_est_norm), rtol=1e-5)
    assert kinds == {0, 1}  # both round types ran


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("kind", ["engine", "randk", "block_randk"])
def test_binclass_trajectory_equals_reference(data, kind, carry):
    jdata, tdata = data
    jm, tm = _pair(kind, carry)
    _run_both(jm, tm, jdata, tdata, lambda k: (jdata,), lambda k: (tdata,))


def _minibatch(data, k, rows=8):
    """Round k's b′-minibatch: rows [8k, 8k + 8) mod M of every worker."""
    idx = (np.arange(rows) + rows * k) % M
    return type(data)(*(t[:, idx] for t in data))


def _wire(kind, n=N):
    """(reference compressor, engine) and the port's, for one wire."""
    if kind == "engine_randk":
        return (JBlockRandK(kb=8, block=128),
                j_make_engine(jnp.zeros((D,)), kb=8, block=128, backend="ref"),
                BlockRandK(kb=8, block=128),
                make_engine(torch.zeros(D), kb=8, block=128, device="cpu"))
    if kind == "engine_permk":
        return (JPermK(n=n, block=128),
                j_make_engine(jnp.zeros((D,)), block=128, backend="ref", sampler="permk"),
                PermK(n=n, block=128),
                make_engine(torch.zeros(D), block=128, device="cpu", sampler="permk"))
    if kind == "tree_permk":
        return JPermK(n=n, block=128), None, PermK(n=n, block=128), None
    return JRandK(k=16), None, RandK(k=16), None


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("kind", ["engine_randk", "engine_permk", "tree_permk",
                                  "tree_randk"])
def test_vr_marina_trajectory_equals_reference(data, kind, carry):
    jdata, tdata = data
    jc, jeng, tc, teng = _wire(kind)
    jg = jax.grad(j_loss)
    jm = JVRMarina(jg, jg, jc, gamma=0.5, p=0.3, engine=jeng, carry=carry)
    tm = VRMarina(binclass_grad, binclass_grad, tc, gamma=0.5, p=0.3, engine=teng,
                  carry=carry)
    jmb = [_minibatch(jdata, k) for k in range(ROUNDS)]
    tmb = [_minibatch(tdata, k) for k in range(ROUNDS)]
    _run_both(jm, tm, jdata, tdata, lambda k: (jdata, jmb[k]),
              lambda k: (tdata, tmb[k]))


PP_DIALS = {  # (replace, weights)
    "iid": (True, None),
    "distinct": (False, None),
    "weighted": (True, [1.0, 2.0, 3.0, 4.0]),
}


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("dials", list(PP_DIALS))
@pytest.mark.parametrize("kind", ["engine_randk", "tree_randk"])
def test_pp_marina_trajectory_equals_reference(data, kind, dials, carry):
    jdata, tdata = data
    replace, weights = PP_DIALS[dials]
    jc, jeng, tc, teng = _wire(kind)
    jm = JPPMarina(jax.grad(j_loss), jc, gamma=0.5, p=0.3, r=2, engine=jeng,
                   replace=replace, carry=carry,
                   weights=None if weights is None else jnp.asarray(weights))
    tm = PPMarina(binclass_grad, tc, gamma=0.5, p=0.3, r=2, engine=teng,
                  replace=replace, weights=weights, carry=carry)
    _run_both(jm, tm, jdata, tdata, lambda k: (jdata,), lambda k: (tdata,))


def test_binclass_grad_and_smoothness_match_reference(data):
    jdata, tdata = data
    np.testing.assert_allclose(binclass_smoothness(tdata), j_smoothness(jdata),
                               rtol=1e-6)
    x = np.random.default_rng(0).standard_normal(D).astype(np.float32) * 0.1
    for w in range(N):
        jb = jax.tree.map(lambda a: a[w], jdata)
        tb = jax.tree.map(lambda a: a[w], tdata)  # NamedTuple of tensors
        np.testing.assert_allclose(
            binclass_grad(torch.from_numpy(x), tb).numpy(),
            np.asarray(jax.grad(j_loss)(jnp.asarray(x), jb)), rtol=1e-5, atol=1e-6)


def test_port_binclass_generator_is_seeded():
    a = make_synthetic_binclass(3, 2, 8, 16, device="cpu")
    b = make_synthetic_binclass(3, 2, 8, 16, device="cpu")
    assert a.a.shape == (2, 8, 16) and torch.equal(a.a, b.a) and torch.equal(a.y, b.y)
    assert set(torch.unique(a.y).tolist()) <= {-1.0, 1.0}


# ---------------------------------------------------------------------------
# The packed QSGD wire and the compressed downlink, round by round
# ---------------------------------------------------------------------------

FLIP_SHARE = 1e-3  # flagged coordinates, of all compared


def _quantized_pair(method, wire_kind, carry):
    """The reference optimizer and the port's on one of the quantized wires,
    with each package's step arguments for round k."""
    jdown = tdown = None
    if wire_kind == "qsgd":
        jc, tc = JBlockQSGD(s=7, block=128), BlockQSGD(s=7, block=128)
        jeng = j_make_engine(jnp.zeros((D,)), block=128, backend="ref", sampler="qsgd", s=7)
        teng = make_engine(torch.zeros(D), block=128, device="cpu", sampler="qsgd", s=7)
    else:  # RandK uplink, QSGD broadcast
        jc, jeng, tc, teng = _wire("engine_randk")
        jdown = j_make_downlink(jeng, sampler="qsgd", s=7)
        tdown = make_downlink(teng, sampler="qsgd", s=7)
    jkw = dict(gamma=0.5, p=0.3, engine=jeng, carry=carry, down_engine=jdown)
    tkw = dict(gamma=0.5, p=0.3, engine=teng, carry=carry, down_engine=tdown)
    jg = jax.grad(j_loss)
    if method == "marina":
        return JMarina(jg, jc, **jkw), Marina(binclass_grad, tc, **tkw), None
    if method == "vr_marina":
        return (JVRMarina(jg, jg, jc, **jkw),
                VRMarina(binclass_grad, binclass_grad, tc, **tkw), _minibatch)
    return JPPMarina(jg, jc, r=2, **jkw), PPMarina(binclass_grad, tc, r=2, **tkw), None


def _close_except_flips(got, want, step) -> int:
    """rtol 1e-5 / atol 1e-6, except at flagged coordinates, which must lie
    within ``step`` (one quantization step) of the reference. Returns the
    number flagged."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    err, tol = np.abs(got - want), 1e-6 + 1e-5 * np.abs(want)
    flagged = err > tol
    assert (err[flagged] <= step * (1 + 1e-4) + tol[flagged]).all(), (
        err[flagged].max(), step)
    return int(flagged.sum())


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("method", ["marina", "vr_marina", "pp_marina"])
@pytest.mark.parametrize("wire_kind", ["qsgd", "downlink"])
def test_quantized_rounds_match_reference_round_by_round(data, wire_kind, method,
                                                         carry, monkeypatch):
    jdata, tdata = data
    jm, tm, mb = _quantized_pair(method, wire_kind, carry)
    steps = []  # one quantization step per QSGD payload of the port's round
    payloads = tflat.FlatEngine._qsgd_payloads

    def recording(self, key, bufs, n):
        levels, norms = payloads(self, key, bufs, n)
        steps.append(float(norms.max()) / (self.s * n))
        return levels, norms

    monkeypatch.setattr(tflat.FlatEngine, "_qsgd_payloads", recording)
    jargs = (lambda k: (jdata, _minibatch(jdata, k))) if mb else (lambda k: (jdata,))
    targs = (lambda k: (tdata, _minibatch(tdata, k))) if mb else (lambda k: (tdata,))
    js = jm.init(jnp.zeros((D,)), jdata)
    jstep = jax.jit(jm.step)
    kinds, flagged, compared = set(), 0, 0
    for k in range(ROUNDS):
        ts = state_from_jax(np.asarray(js.params), np.asarray(js.g), k,
                            None if js.h is None else np.asarray(js.h), device="cpu")
        steps.clear()
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *jargs(k))
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *targs(k))
        assert tmet.sync_round == int(jmet.sync_round)
        assert tmet.bits_per_worker == float(jmet.bits_per_worker)
        assert tmet.down_bits == float(jmet.down_bits)
        assert tmet.oracle_calls == float(jmet.oracle_calls)
        kinds.add(tmet.sync_round)
        assert bool(steps) == (not tmet.sync_round)
        step = sum(steps)
        flagged += _close_except_flips(ts.params.numpy(), js.params, 0.5 * step)
        flagged += _close_except_flips(_g_vec(ts.g), _g_vec(js.g), step)
        compared += 2 * D
    assert kinds == {0, 1}
    assert flagged <= FLIP_SHARE * compared


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("wire_kind", ["qsgd", "downlink"])
def test_quantized_marina_free_run_matches_reference(data, wire_kind, carry):
    """Run free: c_k and both ledgers equal every round, and the final
    loss within rtol 1e-4 of the reference's."""
    jdata, tdata = data
    jm, tm, _ = _quantized_pair("marina", wire_kind, carry)
    js = jm.init(jnp.zeros((D,)), jdata)
    ts = tm.init(torch.zeros(D), tdata)
    jstep = jax.jit(jm.step)
    for k in range(ROUNDS):
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), jdata)
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), tdata)
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits))
    jloss = sum(float(j_loss(js.params, jax.tree.map(lambda a: a[w], jdata)))
                for w in range(N))
    tloss = sum(float(j_loss(jnp.asarray(ts.params.numpy()),
                             jax.tree.map(lambda a: a[w], jdata))) for w in range(N))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_quantized_marina_tree_path_equals_flat_path(data, carry):
    """Same seeds ⇒ the per-leaf BlockQSGD path and the packed-wire engine
    give identical trajectories (single leaf, d a multiple of the block)."""
    _, tdata = data
    comp = BlockQSGD(s=7, block=128)
    eng = make_engine(torch.zeros(D), block=128, device="cpu", sampler="qsgd", s=7)
    m_tree = Marina(binclass_grad, comp, gamma=0.5, p=0.3, carry=carry)
    m_flat = Marina(binclass_grad, comp, gamma=0.5, p=0.3, engine=eng, carry=carry)
    st_t, st_f = m_tree.init(torch.zeros(D), tdata), m_flat.init(torch.zeros(D), tdata)
    kinds = set()
    for k in range(ROUNDS):
        st_t, met_t = m_tree.step(st_t, prng.PRNGKey(k), tdata)
        st_f, met_f = m_flat.step(st_f, prng.PRNGKey(k), tdata)
        assert met_t.bits_per_worker == met_f.bits_per_worker
        kinds.add(met_f.sync_round)
        assert torch.equal(st_t.params, st_f.params)
        assert np.array_equal(_g_vec(st_t.g.numpy()), _g_vec(st_f.g.numpy()))
    assert kinds == {0, 1}


def test_bf16_params_packed_quantized_round_smoke():
    """bf16 params survive packed-QSGD compressed rounds on the engine, with
    a QSGD downlink on top."""
    n = 3
    params = {"w": torch.full((4, 40), 0.5, dtype=torch.bfloat16),
              "b": torch.zeros(10, dtype=torch.bfloat16)}
    gen = torch.Generator().manual_seed(0)
    batches = {k: torch.randn((n, *v.shape), generator=gen) for k, v in params.items()}

    def grad(p, batch):
        return {k: 2 * (p[k].float() - batch[k]).to(p[k].dtype) for k in p}

    eng = make_engine(params, block=128, device="cpu", sampler="qsgd", s=7)
    for down in (None, make_downlink(eng, sampler="qsgd", s=7)):
        for carry in (False, True):
            m = Marina(grad, BlockQSGD(s=7, block=128), gamma=0.01, p=0.5,
                       engine=eng, carry=carry, down_engine=down)
            st = m.init(params, batches)
            seen = set()
            for k in range(12):
                st, met = m.step(st, prng.PRNGKey(k), batches)
                seen.add(met.sync_round)
            assert seen == {0, 1}
            # g is a bf16 tree on recompute rounds, the packed f32 buffer on carry
            g_leaves = [st.g] if carry else list(st.g.values())
            for leaf in (*st.params.values(), *g_leaves):
                assert bool(torch.isfinite(leaf.float()).all())
                assert leaf.dtype == (torch.float32 if leaf is st.g else torch.bfloat16)


def test_downlink_ledger_drift_guard(data):
    """StepMetrics.down_bits equals the wire formulas in both round types:
    32d on sync rounds, the Q_down payload on compressed ones; the uplink
    column is untouched by the downlink; up + down of a compressed round
    drops at least 4× against the dense broadcast."""
    _, tdata = data
    _, _, comp, eng = _wire("engine_randk")
    m = Marina(binclass_grad, comp, gamma=0.05, p=0.5, engine=eng, carry=True,
               down_engine=make_downlink(eng, sampler="qsgd", s=7))
    st = m.init(torch.zeros(D), tdata)
    lay = eng.layout
    down_q = wire.block_qsgd_bits(lay.nblk, lay.block, 7)
    up_q = wire.seeded_randk_bits(lay.nblk, 8)
    seen = set()
    for k in range(ROUNDS):
        st, met = m.step(st, prng.PRNGKey(k), tdata)
        if met.sync_round:
            assert met.down_bits == wire.downlink_dense_bits(D)
            assert met.bits_per_worker == 32.0 * D
        else:
            assert (met.down_bits, met.bits_per_worker) == (down_q, up_q)
        seen.add(met.sync_round)
    assert seen == {0, 1}
    assert (up_q + wire.downlink_dense_bits(D)) / (up_q + down_q) >= 4.0


def test_no_downlink_books_dense_broadcast(data):
    _, tdata = data
    m = Marina(binclass_grad, BlockRandK(kb=8, block=128), gamma=0.05, p=0.5)
    st = m.init(torch.zeros(D), tdata)
    for k in range(6):
        st, met = m.step(st, prng.PRNGKey(k), tdata)
        assert met.down_bits == 32.0 * D


def test_downlink_refusals():
    """carry + engine consumes the downlink inside the epilogue kernel: a
    per-leaf down_compressor there is refused (ValueError, as in the
    reference); elsewhere a tree down_compressor is taken."""
    _, _, comp, eng = _wire("engine_randk")
    tree_down = RandK(k=16)
    for make in (lambda **kw: Marina(binclass_grad, comp, 0.05, 0.3, **kw),
                 lambda **kw: VRMarina(binclass_grad, binclass_grad, comp, 0.05, 0.3, **kw),
                 lambda **kw: PPMarina(binclass_grad, comp, 0.05, 0.3, 2, **kw)):
        with pytest.raises(ValueError, match="down_engine"):
            make(engine=eng, carry=True, down_compressor=tree_down)
        assert make(engine=eng, carry=False, down_compressor=tree_down).down_compressor \
            is tree_down
        make(engine=eng, carry=True, down_engine=make_downlink(eng))
