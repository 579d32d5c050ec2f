"""The paper's baselines and the compressors they use, ported, against the
reference (``repro.core``) under the same keys.

* ``core/stepsize.py``: every function equal to the reference's over a grid
  (the port keeps its own copy: the reference's module is verbatim, but
  importing it pulls in JAX).
* ``TopK``: the same indices as ``lax.top_k``, ties to the lowest index
  first (``torch.topk`` picks another set on ties); ``QSGD`` (global norm):
  levels bit-equal given the reference's norm, the norm within
  ``NORM_ULP`` ulp (XLA's sum order is unspecified); ``tree_omega``.
* DIANA, VR-DIANA, DCGD, EC-SGD and GD on the eq. (11) binclass problem
  (n = 4, d = 512), 20 rounds from the same start under the same keys:
  the bits ledger, the oracle count and the snapshot coin equal every round;
  params within rtol 1e-5 / atol 1e-6 (torch and XLA reduce the gradient's
  matmuls in different orders — ROADMAP C) for the wires whose draws are
  exact (RandK, Block-RandK, TopK, identity). The quantizing wires
  (block_natural, QSGD) are held round by round from the reference's state:
  a flipped code or level, once made, would move every later round. There
  params and the shifts lie within rtol 1e-5 / atol 1e-6 except at flagged
  coordinates, within one quantization step, at most ``FLIP_SHARE`` of all.
* The trainer's ``diana``, ``dcgd``, ``ec_sgd`` and ``gd`` on the small LM:
  finite losses, the ledger equal to the reference compressor's
  ``tree_payload_bits``, DIANA's default α equal to the reference's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro.core import DCGD as JDCGD
from repro.core import ECSGD as JECSGD
from repro.core import QSGD as JQSGD
from repro.core import BlockNatural as JBlockNatural
from repro.core import BlockRandK as JBlockRandK
from repro.core import Diana as JDiana
from repro.core import RandK as JRandK
from repro.core import TopK as JTopK
from repro.core import VRDiana as JVRDiana
from repro.core import diana_alpha as j_diana_alpha
from repro.core import make_compressor as j_make_compressor
from repro.core import make_gd as j_make_gd
from repro.core import stepsize as jstep
from repro.core import tree_omega as j_tree_omega
from repro.core import tree_payload_bits as j_tree_payload_bits
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro.models import init_params as j_init_params
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_stack as j_dense_stack
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    DCGD,
    ECSGD,
    DCGDState,
    QSGD,
    BlockNatural,
    BlockRandK,
    Diana,
    DianaState,
    RandK,
    TopK,
    VRDiana,
    VRDianaState,
    make_compressor,
    make_gd,
    stepsize,
    tree_omega,
)
from repro_torch.core.problems import binclass_grad
from repro_torch.core.tree_util import tree_leaves
from repro_torch.models import ModelConfig, dense_stack, init_params
from repro_torch.train import TrainConfig, Trainer

NORM_ULP = 5
FLIP_SHARE = 1e-3
N, M, D = 4, 32, 512
ROUNDS = 20


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Stepsizes and the compressors
# ---------------------------------------------------------------------------


def test_stepsize_equals_reference():
    names = [n for n in dir(jstep) if callable(getattr(jstep, n)) and not n.startswith("_")
             and getattr(jstep, n).__module__ == jstep.__name__]
    assert names == [n for n in dir(stepsize) if callable(getattr(stepsize, n))
                     and not n.startswith("_")
                     and getattr(stepsize, n).__module__ == stepsize.__name__]
    for L in (0.5, 3.0):
        for omega in (0.0, 0.125, 7.0, 127.0):
            for p in (0.01, 0.3, 1.0):
                for n in (1, 4, 16):
                    assert stepsize.marina_gamma(L, omega, p, n) == \
                        jstep.marina_gamma(L, omega, p, n)
                    assert stepsize.marina_gamma_pl(L, omega, p, n, 0.1) == \
                        jstep.marina_gamma_pl(L, omega, p, n, 0.1)
                    assert stepsize.vr_marina_gamma(L, 2 * L, omega, p, n, 3) == \
                        jstep.vr_marina_gamma(L, 2 * L, omega, p, n, 3)
                    assert stepsize.pp_marina_gamma(L, omega, p, n) == \
                        jstep.pp_marina_gamma(L, omega, p, n)
                    assert stepsize.diana_gamma(L, omega, n) == jstep.diana_gamma(L, omega, n)
                    assert stepsize.ab_from_omega(omega, n) == jstep.ab_from_omega(omega, n)
                    assert stepsize.marina_gamma_ab(L, 1.0, 0.5, p) == \
                        jstep.marina_gamma_ab(L, 1.0, 0.5, p)
                    assert stepsize.marina_gamma_permk(L, p, 2 * L, L) == \
                        jstep.marina_gamma_permk(L, p, 2 * L, L)
                    assert stepsize.async_marina_gamma(L, omega, p, n, 0.5, 1.5) == \
                        jstep.async_marina_gamma(L, omega, p, n, 0.5, 1.5)
                    assert stepsize.marina_iteration_bound(1.0, L, omega, p, n, 0.1) == \
                        jstep.marina_iteration_bound(1.0, L, omega, p, n, 0.1)
                assert stepsize.diana_alpha(omega) == jstep.diana_alpha(omega)
        for rule, f in (("mean", 0), ("trimmed_mean", 1), ("coordinate_median", 0),
                        ("krum", 0), ("norm_clip", 0)):
            assert stepsize.robust_n_eff(rule, 5, f) == jstep.robust_n_eff(rule, 5, f)
            assert stepsize.robust_marina_gamma(L, 3.0, 0.2, 5, rule, f) == \
                jstep.robust_marina_gamma(L, 3.0, 0.2, 5, rule, f)
    assert stepsize.permk_default_p(8) == jstep.permk_default_p(8)
    assert stepsize.marina_comm_per_worker(100, 8.0, 0.1, 50.0) == \
        jstep.marina_comm_per_worker(100, 8.0, 0.1, 50.0)


@pytest.mark.parametrize("k", [1, 3, 8, 0.25])
def test_topk_takes_ties_lowest_index_first(k):
    """``|x| = [0,3,3,1,3,0,0,1,2,0]`` with k = 8: ``lax.top_k`` keeps
    index 0 and 5 among the zeros (``torch.topk`` would keep another), and
    the port keeps the reference's set. Then random data with zeros."""
    tied = np.array([0, 3, -3, 1, 3, 0, 0, -1, 2, 0], np.float32)
    rng = np.random.default_rng(3)
    rand = rng.standard_normal(300).astype(np.float32)
    rand[rng.random(300) < 0.3] = 0.0
    for x in (tied, rand):
        jc, tc = JTopK(k=k), make_compressor("topk", k=k)
        assert isinstance(tc, TopK)
        jp = jc.compress(None, jnp.asarray(x))
        tp = tc.compress(None, _t(x))
        np.testing.assert_array_equal(tp["indices"].numpy(), np.asarray(jp["indices"]))
        np.testing.assert_array_equal(tp["values"].numpy(), np.asarray(jp["values"]))
        np.testing.assert_array_equal(tc.decompress(tp, x.size).numpy(),
                                      np.asarray(jc.decompress(jp, x.size)))
        d = x.size
        assert (tc.k_for(d), tc.delta(d), tc.payload_bits(d), tc.expected_density(d)) == (
            jc.k_for(d), jc.delta(d), jc.payload_bits(d), jc.expected_density(d))
        assert not tc.unbiased


@pytest.mark.parametrize("s", [1, 4, 127])
def test_qsgd_levels_bit_equal_given_reference_norm(s):
    rng = np.random.default_rng(s)
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    x[:10] = 0.0
    jc, tc = JQSGD(s=s), make_compressor("qsgd", s=s)
    assert isinstance(tc, QSGD)
    jp = jc.compress(jax.random.PRNGKey(s), jnp.asarray(x))
    tp = tc.compress(prng.PRNGKey(s), _t(x))
    assert ulp_diff(tp["norm"].reshape(1), np.asarray(jp["norm"]).reshape(1)) <= NORM_ULP
    # the quantize step against the reference's norm: bit-equal
    u = prng.uniform(prng.PRNGKey(s), (1000,))
    level = np.floor((np.abs(x) * np.float32(s)) / np.float32(jp["norm"]) + u)
    np.testing.assert_array_equal((np.sign(x) * level).astype(np.int8), np.asarray(jp["q"]))
    assert (np.abs(tp["q"].numpy().astype(int) - np.asarray(jp["q"]).astype(int)) <= 1).all()
    dec_t = tc.decompress(tp, 1000).numpy()
    dec_j = np.asarray(jc.decompress(jp, 1000))
    same = tp["q"].numpy() == np.asarray(jp["q"])
    np.testing.assert_allclose(dec_t[same], dec_j[same], rtol=(NORM_ULP + 2) * 2**-23)
    d = 1000
    assert (tc.omega(d), tc.payload_bits(d), tc.expected_density(d)) == (
        jc.omega(d), jc.payload_bits(d), jc.expected_density(d))


def test_tree_omega_equals_reference():
    tree = {"a": np.zeros((40, 70), np.float32), "b": np.zeros((500,), np.float32),
            "c": np.zeros((3,), np.float32)}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_jax(tree, device="cpu")
    for name, kw in (("randk", {"k": 0.1}), ("randk", {"k": 16}), ("qsgd", {"s": 4}),
                     ("block_randk", {"kb": 8, "block": 128}), ("natural", {}),
                     ("block_natural", {"block": 256}), ("block_qsgd", {"s": 7}),
                     ("identity", {})):
        assert tree_omega(make_compressor(name, **kw), ttree) == \
            j_tree_omega(j_make_compressor(name, **kw), jtree)


# ---------------------------------------------------------------------------
# Trajectories on the binclass problem
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def binclass():
    jdata = j_make_binclass(jax.random.PRNGKey(0), N, M, D)
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def _comps(name):
    return {"randk": (JRandK(k=16), RandK(k=16)),
            "block_randk": (JBlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)),
            "block_natural": (JBlockNatural(block=128), BlockNatural(block=128)),
            "qsgd": (JQSGD(s=4), QSGD(s=4)),
            "topk": (JTopK(k=32), TopK(k=32))}[name]


def _minibatch(data, k, rows=8):
    """Rows [8k mod M, …) of every worker's data: the minibatch of round k."""
    idx = (np.arange(rows) + rows * k) % M
    return jax.tree.map(lambda a: a[:, idx], data)


def _methods(method, comp_name):
    jc, tc = _comps(comp_name)
    jg = jax.grad(j_loss)
    if method == "diana":
        return JDiana(jg, jc, 0.3, 0.4, N), Diana(binclass_grad, tc, 0.3, 0.4, N)
    if method == "vr_diana":
        return (JVRDiana(jg, jg, jc, 0.3, 0.4, N, 0.3),
                VRDiana(binclass_grad, binclass_grad, tc, 0.3, 0.4, N, 0.3))
    if method == "dcgd":
        return JDCGD(jg, jc, 0.5, N), DCGD(binclass_grad, tc, 0.5, N)
    return JECSGD(jg, jc, 0.5, N), ECSGD(binclass_grad, tc, 0.5, N)


def _init(m, params, data):
    if isinstance(m, (JVRDiana, VRDiana)):
        return m.init(params, data)
    return m.init(params)


def _step_args(m, data, k):
    if isinstance(m, (JVRDiana, VRDiana)):
        return data, _minibatch(data, k)
    return (data,)


def _check_metrics(tmet, jmet):
    assert tmet.sync_round == int(jmet.sync_round)
    assert tmet.bits_per_worker == float(jmet.bits_per_worker)
    assert tmet.down_bits == float(jmet.down_bits)
    assert tmet.oracle_calls == float(jmet.oracle_calls)


@pytest.mark.parametrize("method,comp", [
    ("diana", "randk"), ("diana", "block_randk"), ("vr_diana", "randk"),
    ("vr_diana", "block_randk"), ("dcgd", "randk"), ("dcgd", "block_randk"),
    ("ec_sgd", "topk")])
def test_baseline_trajectories_equal_reference(binclass, method, comp):
    jdata, tdata = binclass
    jm, tm = _methods(method, comp)
    x0 = np.zeros((D,), np.float32)
    js, ts = _init(jm, jnp.asarray(x0), jdata), _init(tm, _t(x0), tdata)
    jstep = jax.jit(jm.step)
    refreshes = set()
    for k in range(ROUNDS):
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *_step_args(jm, jdata, k))
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *_step_args(tm, tdata, k))
        _check_metrics(tmet, jmet)
        refreshes.add(tmet.sync_round)
        np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tmet.grad_est_norm), float(jmet.grad_est_norm),
                                   rtol=1e-5)
    if method == "vr_diana":
        assert refreshes == {0, 1}  # the snapshot coin came up both ways


def test_gd_trajectory_equals_reference(binclass):
    jdata, tdata = binclass
    jm, tm = j_make_gd(jax.grad(j_loss), 0.5), make_gd(binclass_grad, 0.5)
    x0 = np.zeros((D,), np.float32)
    js, ts = jm.init(jnp.asarray(x0), jdata), tm.init(_t(x0), tdata)
    jstep = jax.jit(jm.step)
    for k in range(ROUNDS):
        js, jmet = jstep(js, jax.random.PRNGKey(k), jdata)
        ts, tmet = tm.step(ts, prng.PRNGKey(k), tdata)
        _check_metrics(tmet, jmet)
        assert tmet.sync_round == 1
        np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                                   rtol=1e-5, atol=1e-6)


def _close_except_flips(got, want, step) -> int:
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    err, tol = np.abs(got - want), 1e-6 + 1e-5 * np.abs(want)
    flagged = err > tol
    assert (err[flagged] <= step * (1 + 1e-4) + tol[flagged]).all(), (err[flagged].max(), step)
    return int(flagged.sum())


@pytest.mark.parametrize("method,comp", [
    ("diana", "block_natural"), ("diana", "qsgd"), ("vr_diana", "block_natural"),
    ("dcgd", "block_natural"), ("dcgd", "qsgd")])
def test_quantized_baselines_match_reference_round_by_round(binclass, method, comp,
                                                            monkeypatch):
    """From the reference's state each round. A flipped code moves one
    worker's coordinate by at most half its block scale (natural) or by
    norm / s (QSGD); the round's step is the sum of those over the workers'
    payloads, divided by n — times γ for params, α for DIANA's shift mean."""
    jdata, tdata = binclass
    jm, tm = _methods(method, comp)
    steps = []
    cls = type(tm.compressor)
    compress = cls.compress

    def recording(self, key, x):
        pl = compress(self, key, x)
        steps.append(float(pl["scales"].max()) / 2 if "scales" in pl
                     else float(pl["norm"]) / self.s)
        return pl

    monkeypatch.setattr(cls, "compress", recording)
    state_cls = {"diana": DianaState, "vr_diana": VRDianaState, "dcgd": DCGDState}[method]
    js = _init(jm, jnp.zeros((D,)), jdata)
    jstep = jax.jit(jm.step)
    flagged = compared = 0
    for k in range(ROUNDS):
        ts = state_cls(step=k, **{f: _t(np.asarray(getattr(js, f)))
                                  for f in js.__dataclass_fields__ if f != "step"})
        steps.clear()
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *_step_args(jm, jdata, k))
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *_step_args(tm, tdata, k))
        _check_metrics(tmet, jmet)
        step = sum(steps) / N
        flagged += _close_except_flips(ts.params.numpy(), js.params, tm.gamma * step)
        compared += D
        if method != "dcgd":
            flagged += _close_except_flips(ts.h_mean.numpy(), js.h_mean, tm.alpha * step)
            compared += D
    assert flagged <= FLIP_SHARE * compared


# ---------------------------------------------------------------------------
# The trainer's baselines on the small LM
# ---------------------------------------------------------------------------

CFG_KW = dict(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
              tie_embeddings=True, rope_theta=1_000_000.0)
CFG = ModelConfig(segments=dense_stack(2), **CFG_KW)


@pytest.fixture(scope="module")
def lm_params():
    jparams = j_init_params(jax.random.PRNGKey(0), JModelConfig(segments=j_dense_stack(2),
                                                               **CFG_KW))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("method,comp,kw", [
    ("diana", "block_natural", {"block": 128}), ("diana", "randk", {"k": 0.05}),
    ("dcgd", "block_randk", {"kb": 8, "block": 128}), ("dcgd", "natural", {}),
    ("ec_sgd", "topk", {"k": 0.05}), ("gd", "identity", {})])
def test_trainer_baselines_on_small_lm(lm_params, method, comp, kw):
    jparams, params = lm_params
    tc = TrainConfig(method=method, compressor=comp, comp_kwargs=kw, gamma=0.05,
                     n_workers=2, batch_per_worker=2, steps=4, log_every=2)
    tr = Trainer(CFG, tc, params, device="cpu")
    state, hist = tr.run()
    assert all(math.isfinite(v) for v in hist.loss)
    assert hist.skipped_cum[-1] == 0.0
    jcomp = j_make_compressor(comp, **kw)
    want = float(j_tree_payload_bits(jcomp, jparams))
    assert hist.round_bits == [want] * 4
    d = sum(t.numel() for t in tree_leaves(params))
    assert hist.round_down_bits == [32.0 * d] * 4
    assert hist.round_sync == [1 if method == "gd" else 0] * 4
    if method == "diana":
        assert tr.method.alpha == j_diana_alpha(max(j_tree_omega(jcomp, jparams), 1e-9))
    for name, value in vars(state).items():
        if name != "step":
            assert all(torch.isfinite(t).all() for t in tree_leaves(value))
    with pytest.raises(ValueError, match="carry_grads"):
        Trainer(CFG, TrainConfig(method=method, compressor=comp, comp_kwargs=kw,
                                 carry_grads=True), params, device="cpu")


def test_trainer_diana_alpha_dial_and_biased_default():
    params = init_params(0, CFG, device="cpu")
    tc = TrainConfig(method="diana", compressor="topk", comp_kwargs={"k": 0.1},
                     n_workers=2, steps=1)
    assert Trainer(CFG, tc, params, device="cpu").method.alpha == 0.5  # biased: 0.5
    tc.diana_alpha = 0.125
    assert Trainer(CFG, tc, params, device="cpu").method.alpha == 0.125
