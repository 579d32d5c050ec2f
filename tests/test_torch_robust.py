"""Byzantine-robust aggregation and client fault injection: the port against
the reference on the same numpy inputs.

* The trimmed plain versions (``trimmed_mean_rows_ref`` and the two
  epilogues) are bit-equal to ``repro.kernels.ref``'s oracle — g' and x',
  the sign of zero included — for n ∈ {2, 4, 5, 8}, every window
  ``ServerAggregator.trim_bounds`` gives, rows and x in f32 and bf16, and up
  to ``lo`` NaN rows. Against the Pallas kernel (interpret mode): g'
  bit-equal where hi − lo ≤ 2, else within the rounding bound of a sum taken
  in another order (the kernel adds the kept values in worker order, the
  oracle and the port in sorted order); x' within 1 ulp of the reference's
  update applied to the port's g'.
* ``ServerAggregator``: metadata, every rule's ``combine_rows`` and
  ``combine_stacked`` (trim, median and Krum bit-equal; the mean within 1
  ulp; norm-clip within rtol 1e-6, its norms being sums in another order),
  Krum with a NaN row (the winning row's score leads the runner-up by more
  than 1e-3 relative: a clear margin), norm-clip's median on even n and on
  non-finite norms (``jnp.median``'s midpoint, not ``torch.median``).
* ``FaultSpec`` / ``inject``: every attack on prefix, explicit and PP-cohort
  ids; bit-equal except ``garbage``, whose noise is within the
  ``prng.normal`` bound (≤ 3 ulp of ``jax.random.normal``, ×scale).
* Trajectories on the eq. (11) binclass problem, run free for 12 rounds:
  MARINA, VR-MARINA and PP-MARINA (r = 3 of 4) under robust rules and
  faults, on the flat RandK engine and the per-leaf RandK tree path, both
  round shapes; c_k and the bit ledgers (drop's included) equal, params and
  g within rtol 1e-5 / atol 1e-6 (the gradients' matmul order; the rank
  window is a continuous function of its rows). The quantized wires are
  held round by round from the reference's state, flips within one
  quantization step per payload, on binclass and on a 3-worker small LM.
* Mirrors of ``tests/test_robust.py``'s semantic tests on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close_except_flips, one_torch_thread, to_np, ulp_diff  # noqa: F401
from repro.core import BlockNatural as JBlockNatural
from repro.core import BlockQSGD as JBlockQSGD
from repro.core import BlockRandK as JBlockRandK
from repro.core import FaultSpec as JFaultSpec
from repro.core import Marina as JMarina
from repro.core import PPMarina as JPPMarina
from repro.core import RandK as JRandK
from repro.core import ServerAggregator as JServerAggregator
from repro.core import VRMarina as JVRMarina
from repro.core import aggregators as jagg
from repro.core import faults as jfaults
from repro.core import stepsize as jstep
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro.data import HeterogeneousLMData as JData
from repro.data import worker_batches as j_worker_batches
from repro.kernels import epilogue as jepi
from repro.kernels import ref as jref
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_stack as j_dense_stack
from repro_torch import prng
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import (
    ATTACKS,
    BlockNatural,
    BlockQSGD,
    BlockRandK,
    FaultSpec,
    Marina,
    PermK,
    PPMarina,
    RandK,
    ServerAggregator,
    VRMarina,
    flip_binclass_labels,
    make_compressor,
    make_engine,
    robust_marina_gamma,
    robust_n_eff,
    robust_pp_marina_gamma,
)
from repro_torch.core import aggregators as tagg
from repro_torch.core import faults as tfaults
from repro_torch.core import flat as tflat
from repro_torch.core.problems import binclass_grad
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels import ref as tref
from repro_torch.models import ModelConfig, dense_stack, lm_loss

N, M, D = 4, 32, 512
ROUNDS = 12
U = 2.0**-24  # f32 unit roundoff
FLIP_SHARE = 1e-3


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a), device="cpu")


def _bits_equal(got, want) -> bool:
    """Bit patterns equal (−0 ≠ +0), f32 or bf16."""
    return np.array_equal(to_np(got).view(np.int32 if to_np(got).dtype == np.float32
                                          else np.int16),
                          to_np(want).view(np.int32 if to_np(want).dtype == np.float32
                                           else np.int16))


def _windows(n: int) -> list:
    """Every window ``trim_bounds`` gives for n rows."""
    wins = {ServerAggregator("coordinate_median").trim_bounds(n)}
    for f in range(0, (n + 1) // 2):
        if n > 2 * f:
            wins.add(ServerAggregator("trimmed_mean", f).trim_bounds(n))
    return sorted(wins)


def _rows(rng, n, nblk, B, n_nan):
    """Normal rows with ties across workers, ±0, ±inf, and ``n_nan`` NaN rows."""
    rows = rng.standard_normal((n, nblk, B)).astype(np.float32)
    if n > 1:
        rows[1, :, : B // 4] = rows[0, :, : B // 4]
    rows[:, 0, :16] = 0.0
    rows[: max(1, n // 2), 0, :16] = -0.0
    rows[0, 0, 16:24] = -0.0
    rows[n - 1, 0, 24:32] = np.inf
    rows[0, 0, 32:40] = -np.inf
    rows[:n_nan] = np.nan
    return rows


# ---------------------------------------------------------------------------
# The trimmed plain versions against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4, 5, 8])
def test_trimmed_plain_versions_bit_equal_to_reference_oracle(n, bdtype):
    rng = np.random.default_rng(n)
    nblk, B, gamma = 3, 64, 0.0371
    for lo, hi in _windows(n):
        for n_nan in range(lo + 1):
            jb = jnp.asarray(_rows(rng, n, nblk, B, n_nan)).astype(bdtype)
            tb = _t(jb)
            g = rng.standard_normal((nblk, B)).astype(np.float32)
            g[0, :8] = -0.0
            assert _bits_equal(tref.trimmed_mean_rows_ref(tb, lo, hi),
                               jref.trimmed_mean_rows_ref(jb, lo, hi))
            for xdtype in ("float32", "bfloat16"):
                jx = jnp.asarray(rng.standard_normal((nblk, B)).astype(np.float32)).astype(xdtype)
                tx = _t(jx)
                got = tref.trimmed_delta_epilogue_ref(tb, _t(g), tx, gamma, lo, hi)
                want = jref.trimmed_delta_epilogue_ref(jb, jnp.asarray(g), jx, gamma, lo, hi)
                assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
                got = tref.trimmed_sync_epilogue_ref(tb, tx, gamma, lo, hi)
                want = jref.trimmed_sync_epilogue_ref(jb, jx, gamma, lo, hi)
                assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
                assert got[1].dtype == tx.dtype


def test_trimmed_network_orders_negative_zero_below_positive_zero():
    """An odd median of (+0, −0, +0) is +0 and of (−0, +0, −0) is −0, as with
    XLA's min / max (``torch.minimum(0., -0.)`` is +0)."""
    for vals, sign in (([0.0, -0.0, 0.0], False), ([-0.0, 0.0, -0.0], True)):
        rows = torch.tensor(vals)[:, None]
        med = tref.trimmed_mean_rows_ref(rows, 1, 2)
        assert bool(torch.signbit(med)[0]) == sign
        assert _bits_equal(med, jref.trimmed_mean_rows_ref(jnp.asarray(vals)[:, None], 1, 2))
    with pytest.raises(ValueError, match="window"):
        tref.trimmed_mean_rows_ref(torch.zeros(3, 2), 2, 2)


@pytest.mark.parametrize("n", [2, 4, 5, 8])
def test_trimmed_epilogues_match_the_pallas_kernel(n):
    rng = np.random.default_rng(40 + n)
    nblk, B, gamma = 2, 128, 0.0371
    for lo, hi in _windows(n):
        bdtype = "bfloat16" if (lo, hi) == _windows(n)[0] else "float32"
        rows = _rows(rng, n, nblk, B, min(lo, 1))
        jb = jnp.asarray(rows).astype(bdtype)
        g = rng.standard_normal((nblk, B)).astype(np.float32)
        x = rng.standard_normal((nblk, B)).astype(np.float32)
        kept = np.sort(np.where(np.isnan(np.asarray(jb, np.float64)), np.inf,
                                np.asarray(jb, np.float64)), axis=0)[lo:hi]
        m = hi - lo
        for delta in (True, False):
            if delta:
                pg, px = jepi.trimmed_delta_epilogue(jb, jnp.asarray(g), jnp.asarray(x), gamma,
                                                     lo, hi, backend="pallas_interpret")
                tg, tx = tref.trimmed_delta_epilogue_ref(_t(jb), _t(g), _t(x), gamma, lo, hi)
            else:
                pg, px = jepi.trimmed_sync_epilogue(jb, jnp.asarray(x), gamma, lo, hi,
                                                    backend="pallas_interpret")
                tg, tx = tref.trimmed_sync_epilogue_ref(_t(jb), _t(x), gamma, lo, hi)
            if m <= 2:
                assert _bits_equal(tg, pg)
            else:
                with np.errstate(invalid="ignore"):
                    base = np.abs(kept).sum(axis=0) / m + (np.abs(g) if delta else 0.0)
                    err = np.abs(tg.numpy().astype(np.float64) - np.asarray(pg, np.float64))
                tol = 2 * (m + 1) * U * base
                finite = np.isfinite(base)
                assert (err[finite] <= tol[finite]).all()
                assert np.array_equal(tg.numpy()[~finite], np.asarray(pg)[~finite])
            _, jx_from_tg = jref.delta_epilogue_ref(jnp.zeros_like(pg), jnp.asarray(tg.numpy()),
                                                    jnp.asarray(x), gamma)
            assert ulp_diff(tx, jx_from_tg) <= 1


# ---------------------------------------------------------------------------
# ServerAggregator
# ---------------------------------------------------------------------------

RULE_CASES = [("mean", 0), ("trimmed_mean", 1), ("trimmed_mean", 2),
              ("coordinate_median", 0), ("krum", 1), ("norm_clip", 0)]


def test_aggregator_metadata_equals_reference():
    for rule, f in RULE_CASES:
        ja, ta = JServerAggregator(rule, f), ServerAggregator(rule, f)
        assert (ta.robust, ta.coordinatewise) == (ja.robust, ja.coordinatewise)
        for n in (1, 2, 3, 4, 5, 8):
            for name in ("trim_bounds", "n_eff"):
                try:
                    want = getattr(ja, name)(n)
                except ValueError:
                    with pytest.raises(ValueError):
                        getattr(ta, name)(n)
                    continue
                assert getattr(ta, name)(n) == want
    with pytest.raises(ValueError, match="rule"):
        ServerAggregator("geometric_median")
    with pytest.raises(ValueError, match="f must"):
        ServerAggregator("krum", -1)
    assert tagg.RULES == jagg.RULES


def _agg_rows(rng, n, rule):
    """Rows with a clear Krum margin (a shifted honest cluster and attacked
    rows far away); a NaN row for Krum, a huge and an inf row for norm-clip."""
    rows = rng.standard_normal((n, 3, 50)).astype(np.float32) + 2.0
    rows[0] = -4.0 * rows[2:].mean(0)
    if rule == "krum":
        rows[1] = np.nan
    if rule == "norm_clip":
        rows[1] *= 1e4
        rows[2, 0, 0] = np.inf
    return rows


def _assert_agg_close(rule, got, want):
    got, want = to_np(got), to_np(want)
    if rule in ("trimmed_mean", "coordinate_median", "krum"):
        assert np.array_equal(got, want)
    elif rule == "mean":
        assert ulp_diff(got, want) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip_tau", [None, 2.0])
@pytest.mark.parametrize("n", [5, 6])
@pytest.mark.parametrize("rule,f", RULE_CASES, ids=lambda v: str(v))
def test_combine_rows_and_stacked_match_reference(rule, f, n, clip_tau):
    if clip_tau is not None and rule != "norm_clip":
        return
    rng = np.random.default_rng(n + 7 * f)
    rows = _agg_rows(rng, n, rule)
    ja, ta = JServerAggregator(rule, f, clip_tau), ServerAggregator(rule, f, clip_tau)
    _assert_agg_close(rule, ta.combine_rows(_t(rows)), ja.combine_rows(jnp.asarray(rows)))
    tree = {"w": rows[:, :2].copy(), "b": rows[:, 2, :30].copy(),
            "c": jnp.asarray(rows[:, 2, 30:]).astype(jnp.bfloat16)}
    jt = jax.tree.map(jnp.asarray, tree)
    got = ta.combine_stacked(params_from_jax(jax.tree.map(np.asarray, tree), device="cpu"))
    want = ja.combine_stacked(jt)
    for k in tree:
        assert got[k].dtype == _t(want[k]).dtype
        if rule == "norm_clip" and k == "c":
            assert ulp_diff(got[k], want[k]) <= 1
        else:
            _assert_agg_close(rule, got[k], want[k])
    if rule == "krum":  # the clear margin behind the bit-equal winner
        flat = torch.from_numpy(rows.reshape(n, -1))
        dists = tagg._pairwise_sq_dists(flat)
        masked = dists + torch.diag(torch.full((n,), float("inf")))
        scores = torch.sum(torch.sort(masked, 1).values[:, : n - f - 2], 1)
        top = torch.sort(torch.where(torch.isfinite(scores), scores,
                                     torch.full_like(scores, float("inf")))).values
        assert top[1] > top[0] * (1 + 1e-3)
        assert np.isfinite(to_np(got["w"])).all()


def test_norm_clip_median_is_jnp_median():
    cases = [[1.0, 2.0, 3.0, np.inf], [1.0, 2.0, np.inf, np.inf], [3.0, 1.0, 2.0],
             [5.0, 5.0, 1.0, 9.0], [np.inf, np.inf, np.inf], [2.0, np.nan, 1.0]]
    rng = np.random.default_rng(0)
    cases += [rng.standard_normal(k).astype(np.float32) for k in (1, 2, 5, 6, 8)]
    for v in cases:
        v = np.asarray(v, np.float32)
        got = tagg.median_midpoint(torch.from_numpy(v))
        want = jnp.median(jnp.asarray(v))
        assert np.array_equal(to_np(got), to_np(want), equal_nan=True), (v, got, want)
    # the two medians the port does not use
    assert float(jnp.median(jnp.asarray([1.0, 2.0, 3.0, np.inf]))) == 2.5
    assert float(torch.median(torch.tensor([1.0, 2.0, 3.0, float("inf")]))) == 2.0
    for tau in (None, 3.0):
        norms = np.asarray([1.0, np.inf, 4.0, np.nan, 2.0, 8.0], np.float32)
        np.testing.assert_array_equal(
            tagg._clip_scales(torch.from_numpy(norms), tau).numpy(),
            np.asarray(jagg._clip_scales(jnp.asarray(norms), tau)))


# ---------------------------------------------------------------------------
# FaultSpec and inject
# ---------------------------------------------------------------------------


def test_faultspec_masks_and_validation_equal_reference():
    for kw in ({"frac": 0.25}, {"frac": 0.5}, {"ids": (3, 1)}, {"ids": (1, 9)}, {"ids": ()}):
        js, ts = JFaultSpec("drop", **kw), FaultSpec("drop", **kw)
        assert ts.ids == js.ids
        for n in (1, 4, 5, 8):
            assert ts.n_faulty(n) == js.n_faulty(n)
            for ids in (list(range(n)), [2, 0, 2, 3][:n]):
                ids = [i % n for i in ids]
                np.testing.assert_array_equal(ts.byz_mask(ids, n).numpy(),
                                              np.asarray(js.byz_mask(jnp.asarray(ids), n)))
    for bad in ({"attack": "flood"}, {"frac": 1.5}, {"ids": (-1,)}, {"ids": (2, 2)},
                {"ids": (1.0,)}):
        with pytest.raises(ValueError):
            FaultSpec(**{"attack": "drop", **bad})
    assert tfaults.ATTACKS == jfaults.ATTACKS


def _payload_tree(rng, rows):
    # insertion order differs from the sorted leaf order garbage keys follow
    return {"w": rng.standard_normal((rows, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((rows, 17)).astype(np.float32),
            "c": np.asarray(jnp.asarray(rng.standard_normal((rows, 9))).astype(jnp.bfloat16))}


@pytest.mark.parametrize("ids_kind", ["prefix", "explicit", "cohort"])
@pytest.mark.parametrize("attack", ATTACKS)
def test_inject_and_zero_rows_match_reference(attack, ids_kind):
    n = 4
    rng = np.random.default_rng(len(attack))
    ids = {"prefix": [0, 1, 2, 3], "explicit": [0, 1, 2, 3], "cohort": [2, 0, 2]}[ids_kind]
    kw = {"ids": (1, 2)} if ids_kind != "prefix" else {"frac": 0.5}
    js, ts = JFaultSpec(attack, scale=3.0, **kw), FaultSpec(attack, scale=3.0, **kw)
    tree = _payload_tree(rng, len(ids))
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 0xFA17)
    tkey = prng.fold_in(prng.PRNGKey(3), 0xFA17)
    want = jfaults.inject(js, jkey, jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), n)
    got = tfaults.inject(ts, tkey, params_from_jax(tree, device="cpu"), ids, n)
    for k in tree:
        if attack == "garbage":
            assert ulp_diff(got[k], want[k]) <= (4 if k != "c" else 1)
        else:
            assert np.array_equal(to_np(got[k]), to_np(want[k]), equal_nan=True)
    mask = ts.byz_mask(ids, n)
    zj = jfaults.zero_rows(jax.tree.map(jnp.asarray, tree), js.byz_mask(jnp.asarray(ids), n))
    zt = tfaults.zero_rows(params_from_jax(tree, device="cpu"), mask)
    for k in tree:
        assert _bits_equal(zt[k], zj[k])


def test_flip_binclass_labels_matches_reference():
    jdata = j_make_binclass(jax.random.PRNGKey(1), 4, 8, 6)
    tdata = params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")
    got = flip_binclass_labels(tdata, 2)
    want = jfaults.flip_binclass_labels(jdata, 2)
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    assert torch.equal(tdata.y, params_from_jax(np.asarray(jdata.y), device="cpu"))


# ---------------------------------------------------------------------------
# Trajectories on the binclass problem
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    jdata = j_make_binclass(jax.random.PRNGKey(0), N, M, D)
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def _minibatch(data, k, rows=8):
    idx = (np.arange(rows) + rows * k) % M
    return type(data)(*(t[:, idx] for t in data))


def _dials(rule, f, attack, frac, scale, ids=None):
    jagg_, tagg_ = ((None, None) if rule == "mean"
                    else (JServerAggregator(rule, f), ServerAggregator(rule, f)))
    kw = {"ids": ids} if ids is not None else {"frac": frac}
    return (jagg_, JFaultSpec(attack, scale=scale, **kw)), (tagg_, FaultSpec(attack, scale=scale, **kw))


def _robust_pair(method, kind, carry, dials):
    """The reference optimizer and the port's under the same dials, on the
    flat RandK engine or the per-leaf RandK tree path; PP samples r = 3."""
    (ja, jf), (ta, tf) = dials
    if kind == "engine":
        jc, tc = JBlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)
        jeng = j_make_engine(jnp.zeros((D,)), kb=8, block=128, backend="ref")
        teng = make_engine(torch.zeros(D), kb=8, block=128, device="cpu")
    else:
        jc, tc, jeng, teng = JRandK(k=16), RandK(k=16), None, None
    jkw = dict(gamma=0.5, p=0.3, engine=jeng, carry=carry, aggregator=ja, faults=jf)
    tkw = dict(gamma=0.5, p=0.3, engine=teng, carry=carry, aggregator=ta, faults=tf)
    jg = jax.grad(j_loss)
    if method == "marina":
        return JMarina(jg, jc, **jkw), Marina(binclass_grad, tc, **tkw)
    if method == "vr_marina":
        return JVRMarina(jg, jg, jc, **jkw), VRMarina(binclass_grad, binclass_grad, tc, **tkw)
    return JPPMarina(jg, jc, r=3, **jkw), PPMarina(binclass_grad, tc, r=3, **tkw)


#: (method, rule, f, attack, frac, scale, explicit ids)
TRAJECTORIES = [
    ("marina", "trimmed_mean", 1, "sign_flip", 0.25, 10.0, None),
    ("marina", "coordinate_median", 0, "mean_shift", 0.25, 1.0, None),
    ("marina", "krum", 1, "garbage", 0.25, 1.0, None),
    ("marina", "norm_clip", 0, "nan", 0.25, 1.0, None),
    ("marina", "mean", 0, "drop", 0.25, 1.0, None),
    ("vr_marina", "trimmed_mean", 1, "sign_flip", 0.25, 10.0, None),
    ("vr_marina", "mean", 0, "drop", 0.0, 1.0, (2,)),
    ("pp_marina", "coordinate_median", 0, "mean_shift", 0.25, 2.0, None),
    ("pp_marina", "mean", 0, "drop", 0.0, 1.0, (1, 3)),
]
_CASES = [(case, kind, carry) for case in TRAJECTORIES for kind in ("engine", "tree")
          for carry in (False, True) if carry or case[3] != "drop"]


@pytest.mark.parametrize("case,kind,carry", _CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}-{k}-{'carry' if cr else 'recompute'}"
                              for c, k, cr in _CASES])
def test_robust_and_faulted_trajectories_equal_reference(data, case, kind, carry):
    method, rule, f, attack, frac, scale, ids = case
    jdata, tdata = data
    jm, tm = _robust_pair(method, kind, carry, _dials(rule, f, attack, frac, scale, ids))
    x0 = np.zeros((D,), np.float32)
    js, ts = jm.init(jnp.asarray(x0), jdata), tm.init(torch.from_numpy(x0), tdata)
    jstep = jax.jit(jm.step)
    kinds = set()
    for k in range(ROUNDS):
        jargs, targs = (jdata,), (tdata,)
        if method == "vr_marina":
            jargs, targs = (jdata, _minibatch(jdata, k)), (tdata, _minibatch(tdata, k))
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), *jargs)
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), *targs)
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.oracle_calls, tmet.down_bits) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.oracle_calls),
            float(jmet.down_bits))
        kinds.add(tmet.sync_round)
        np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(ts.g).reshape(-1)[:D],
                                   np.asarray(js.g).reshape(-1)[:D], rtol=1e-5, atol=1e-6)
        if carry:
            np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), rtol=1e-5, atol=1e-6)
    assert kinds == {0, 1}
    assert np.isfinite(ts.params.numpy()).all()


def _recording_steps(monkeypatch):
    """One quantization step per worker payload of the port's round: a
    level moves one worker's value by at most norm/s, a natural code by half
    its block scale — and a value of the rank window moves by no more."""
    steps = []
    encode, natural = tflat.FlatEngine.encode_rows, tflat.FlatEngine._natural_payloads

    def rec_qsgd(self, key, bufs, rows, n):
        payload = encode(self, key, bufs, rows, n)
        if "norms" in payload:
            steps.append(float(payload["norms"].max()) / self.s)
        return payload

    def rec_natural(self, key, bufs, n):
        codes, scales = natural(self, key, bufs, n)
        steps.append(float(scales.max()) / 2)
        return codes, scales

    monkeypatch.setattr(tflat.FlatEngine, "encode_rows", rec_qsgd)
    monkeypatch.setattr(tflat.FlatEngine, "_natural_payloads", rec_natural)
    return steps


def _quantized_engines(params_j, params_t, wire_kind, B=128):
    jeng = j_make_engine(params_j, block=B, backend="ref", sampler=wire_kind, s=7)
    teng = make_engine(params_t, block=B, device="cpu", sampler=wire_kind, s=7)
    if wire_kind == "qsgd":
        return jeng, teng, JBlockQSGD(s=7, block=B), BlockQSGD(s=7, block=B)
    return jeng, teng, JBlockNatural(block=B), BlockNatural(block=B)


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("wire_kind,rule", [("qsgd", "trimmed_mean"), ("natural", "krum"),
                                            ("natural", "norm_clip")])
def test_quantized_robust_rounds_match_reference_round_by_round(data, wire_kind, rule,
                                                                carry, monkeypatch):
    """MARINA on the packed QSGD and natural wires under a robust rule and
    sign_flip ×10, held round by round from the reference's state."""
    jdata, tdata = data
    jeng, teng, jc, tc = _quantized_engines(jnp.zeros((D,)), torch.zeros(D), wire_kind)
    (ja, jf), (ta, tf) = _dials(rule, 1, "sign_flip", 0.25, 10.0)
    jm = JMarina(jax.grad(j_loss), jc, gamma=0.5, p=0.3, engine=jeng, carry=carry,
                 aggregator=ja, faults=jf)
    tm = Marina(binclass_grad, tc, gamma=0.5, p=0.3, engine=teng, carry=carry,
                aggregator=ta, faults=tf)
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
        assert (tmet.sync_round, tmet.bits_per_worker) == (int(jmet.sync_round),
                                                          float(jmet.bits_per_worker))
        kinds.add(tmet.sync_round)
        step = sum(steps)
        flagged += close_except_flips(ts.params.numpy(), js.params, 0.5 * step, 1e-5)
        flagged += close_except_flips(np.asarray(ts.g).reshape(-1)[:D],
                                       np.asarray(js.g).reshape(-1)[:D], step, 1e-5)
        compared += 2 * D
    assert kinds == {0, 1}
    assert flagged <= FLIP_SHARE * compared


@pytest.mark.parametrize("sampler", ["randk", "randk_qsgd", "qsgd", "natural"])
def test_worker_dense_matches_reference(sampler):
    """Each worker's decoded row: RandK bit-equal; the quantized wires
    within the norm order's 5 ulp and one quantization step where a level or
    code flips (ROADMAP C). PermK refuses."""
    nblk, B, n = 4, 128, 3
    tree = {"v": np.zeros((nblk * B - 7,), np.float32)}
    jeng = j_make_engine(jax.tree.map(jnp.asarray, tree), kb=8, block=B, backend="ref",
                         sampler=sampler, s=7)
    teng = make_engine(params_from_jax(tree, device="cpu"), kb=8, block=B, device="cpu",
                       sampler=sampler, s=7)
    rng = np.random.default_rng(5)
    bufs = rng.standard_normal((n, nblk, B)).astype(np.float32)
    got = teng.worker_dense(prng.PRNGKey(4), _t(bufs), n).numpy()
    want = np.asarray(jeng.worker_dense(jax.random.PRNGKey(4), jnp.asarray(bufs), n))
    assert got.shape == want.shape == (n, nblk, B) and got.dtype == np.float32
    if sampler == "randk":
        assert np.array_equal(got, want)
    else:
        step = np.abs(bufs).max() * np.sqrt(B)
        err = np.abs(got.astype(np.float64) - want)
        flips = err > 7 * np.spacing(np.abs(want))
        assert (err[flips] <= step).all() and flips.sum() <= FLIP_SHARE * got.size
    perm = make_engine(params_from_jax(tree, device="cpu"), block=B, device="cpu",
                       sampler="permk")
    with pytest.raises(ValueError, match="PermK"):
        perm.worker_dense(prng.PRNGKey(0), _t(bufs[:2]), 2)


# ---------------------------------------------------------------------------
# The small LM, round by round
# ---------------------------------------------------------------------------

CFG_KW = dict(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
              tie_embeddings=True, rope_theta=1_000_000.0, remat=False)
JCFG = JModelConfig(segments=j_dense_stack(1), **CFG_KW)
TCFG = ModelConfig(segments=dense_stack(1), **CFG_KW)


@pytest.fixture(scope="module")
def lm():
    jparams = j_init_params(jax.random.PRNGKey(0), JCFG)
    lm_data = JData(n_workers=3, vocab_size=256, seq_len=16, seed=3)
    fn = jax.jit(lambda s: j_worker_batches(lm_data, s, 2))
    return jparams, [np.asarray(fn(s)) for s in range(5)]


def _tgrad(params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = lm_loss(tree_unflatten(treedef, leaves), TCFG, batch["tokens"])
    return tree_unflatten(treedef, torch.autograd.grad(loss, leaves))


_jgrad = jax.grad(lambda p, b: j_lm_loss(p, JCFG, b["tokens"]))


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_lm_robust_rounds_match_reference_round_by_round(lm, carry, monkeypatch):
    """4 rounds of the small LM (3 workers) over the packed QSGD wire, the
    trimmed mean f = 1 under sign_flip ×10 of worker 0: ledgers equal,
    params and g leafwise within 1e-4 of the leaf's scale except flagged
    coordinates within one step."""
    jparams, tokens = lm
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng, teng, jc, tc = _quantized_engines(jparams, tp, "qsgd")
    (ja, jf), (ta, tf) = _dials("trimmed_mean", 1, "sign_flip", 0.34, 10.0)
    gamma = 0.05
    jm = JMarina(_jgrad, jc, gamma=gamma, p=0.4, engine=jeng, carry=carry,
                 aggregator=ja, faults=jf)
    tm = Marina(_tgrad, tc, gamma=gamma, p=0.4, engine=teng, carry=carry,
                aggregator=ta, faults=tf)
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
        assert (tmet.sync_round, tmet.bits_per_worker) == (int(jmet.sync_round),
                                                          float(jmet.bits_per_worker))
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


# ---------------------------------------------------------------------------
# Mirrors of tests/test_robust.py's semantic tests
# ---------------------------------------------------------------------------

NS, DS = 8, 20


@pytest.fixture(scope="module")
def small():
    jdata = j_make_binclass(jax.random.PRNGKey(0), NS, M, DS)
    return params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def _run(m, data, steps, seed=0):
    st = m.init(torch.zeros(DS), data)
    mets = []
    for k in range(steps):
        st, met = m.step(st, prng.PRNGKey(seed * 100_000 + k), data)
        mets.append(met)
    return st, mets


def _qsgd_marina(aggregator=None, faults=None, carry=False, **kw):
    comp = make_compressor("qsgd", s=7)
    return Marina(binclass_grad, comp, gamma=0.05, p=comp.default_p(DS),
                  aggregator=aggregator, faults=faults, carry=carry, **kw)


def test_nan_attack_poisons_mean_but_not_trimmed(small):
    st, _ = _run(_qsgd_marina(faults=FaultSpec("nan", frac=0.25)), small, 8)
    assert not torch.isfinite(st.params).all()
    st, _ = _run(_qsgd_marina(ServerAggregator("trimmed_mean", f=2),
                              FaultSpec("nan", frac=0.25)), small, 8)
    assert torch.isfinite(st.params).all()


def test_default_dials_are_bit_identical(small):
    st0, m0 = _run(_qsgd_marina(), small, 25)
    st1, m1 = _run(_qsgd_marina(ServerAggregator("mean"), FaultSpec("none", frac=0.0)),
                   small, 25)
    assert torch.equal(st0.params, st1.params)
    assert [m.bits_per_worker for m in m0] == [m.bits_per_worker for m in m1]


def test_pp_drop_ledger_books_actual_uploads_and_keeps_stale_rows(small):
    faults = FaultSpec("drop", frac=0.25)  # ids {0, 1} of 8 never upload
    kw = dict(compressor=make_compressor("qsgd", s=7), gamma=0.05, p=0.3, r=4, carry=True)
    m_drop, m_ok = PPMarina(binclass_grad, faults=faults, **kw), PPMarina(binclass_grad, **kw)
    _, mets_d = _run(m_drop, small, 12)
    _, mets_o = _run(m_ok, small, 12)
    for k, (md, mo) in enumerate(zip(mets_d, mets_o)):
        _, k_sel, _ = prng.split(prng.PRNGKey(k), 3)
        sel = prng.randint(k_sel, (4,), 0, NS)
        uploaded = 4 - int(np.sum(sel < 2))
        if md.sync_round:
            assert md.bits_per_worker == mo.bits_per_worker
        else:
            np.testing.assert_allclose(md.bits_per_worker,
                                       mo.bits_per_worker * uploaded / 4.0, rtol=1e-6)
    m = dataclasses.replace(m_drop, p=0.0)  # no rendezvous: drops never refresh
    st0 = m.init(torch.zeros(DS), small)
    h0 = st0.h.clone()
    st = st0
    for k in range(10):
        st, _ = m.step(st, prng.PRNGKey(k), small)
    assert torch.equal(st.h[:2], h0[:2])
    assert not torch.equal(st.h[2:], h0[2:])


def test_config_refusals_match_reference():
    with pytest.raises(ValueError, match="carry"):
        _qsgd_marina(faults=FaultSpec("drop", frac=0.25))
    with pytest.raises(ValueError, match="mean aggregation"):
        _qsgd_marina(ServerAggregator("trimmed_mean", f=1), FaultSpec("drop", frac=0.25),
                     carry=True)
    eng = make_engine(torch.zeros(256), block=128, device="cpu", sampler="permk")
    with pytest.raises(ValueError, match="permk"):
        Marina(lambda x, b: x, make_compressor("qsgd", s=7), 0.1, 0.5, engine=eng,
               aggregator=ServerAggregator("trimmed_mean", f=1))
    with pytest.raises(ValueError, match="partition compressor permk"):
        VRMarina(lambda x, b: x, lambda x, b: x, PermK(n=4, block=128), 0.1, 0.5,
                 aggregator=ServerAggregator("coordinate_median"))
    with pytest.raises(ValueError, match="weights"):
        PPMarina(lambda x, b: x, RandK(k=4), 0.1, 0.5, r=2, weights=[1.0, 2.0],
                 aggregator=ServerAggregator("krum", f=0))
    # a per-leaf downlink is no refusal (as in the reference)
    Marina(lambda x, b: x, RandK(k=4), 0.1, 0.5, down_compressor=RandK(k=4))


def test_robust_n_eff_and_gamma_equal_reference():
    assert robust_n_eff("mean", 8) == 8
    assert robust_n_eff("trimmed_mean", 8, 2) == 4
    assert robust_n_eff("coordinate_median", 7) == 1
    assert robust_n_eff("coordinate_median", 8) == 2
    assert robust_n_eff("krum", 8, 2) == 1
    with pytest.raises(ValueError):
        robust_n_eff("trimmed_mean", 4, 2)
    assert robust_marina_gamma(1.0, 3.0, 0.1, 8, "trimmed_mean", f=2) == \
        jstep.robust_marina_gamma(1.0, 3.0, 0.1, 8, "trimmed_mean", f=2)
    assert robust_pp_marina_gamma(1.0, 3.0, 0.1, 4, "coordinate_median") == \
        jstep.robust_pp_marina_gamma(1.0, 3.0, 0.1, 4, "coordinate_median")
