"""Deadline-cohort MARINA and the round-time model: the port against the
reference.

* The two equivalence contracts of ``DeadlineMarina``, on the port: a
  deadline never missed is bit-identical to ``Marina(carry=True)``; a fixed
  slow set that always misses with ``tau_max=0`` is bit-identical to
  ``Marina(carry=True, faults=FaultSpec("drop", ids=slow))`` — params, g
  and the bit ledger.
* ``DeadlineMarina``'s trajectory against the reference's (lognormal,
  exponential and fixed-with-slow-set times, late uploads accepted): the
  per-round uploads, staleness and ledger equal, the simulated wall clock
  within 4 ulp (the round times come from ``prng.normal`` /
  ``prng.exponential``, within 3 / 1 ulp of ``jax.random``'s, and XLA's exp),
  params and g within rtol 1e-5. The draws sit ≥ 1e-4 (relative) from the
  deadline, so no upload changes side (checked).
* The late-upload, all-on-time and rendezvous semantics of
  ``tests/test_async.py``, and ``RoundTimeModel``'s validation, samples and
  closed forms against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ulp_diff  # noqa: F401
from repro.core import DeadlineMarina as JDeadlineMarina
from repro.core import RandK as JRandK
from repro.core import RoundTimeModel as JRoundTimeModel
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro.core.roundtime import TIME_FOLD as J_TIME_FOLD
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    TIME_FOLD,
    DeadlineMarina,
    FaultSpec,
    Marina,
    RandK,
    RoundTimeModel,
)
from repro_torch.core.problems import binclass_grad

N, M, D = 5, 48, 20


@pytest.fixture(scope="module")
def data():
    jdata = j_make_binclass(jax.random.PRNGKey(0), N, M, D)
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")


def run_states(method, data, steps, seed=3):
    st = method.init(torch.zeros(D), data)
    states, metrics = [], []
    for k in range(steps):
        st, met = method.step(st, prng.PRNGKey(seed * 100_000 + k), data)
        states.append(st)
        metrics.append(met)
    return states, metrics


def test_never_miss_deadline_bit_identical_to_full_participation(data):
    _, tdata = data
    dm = DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3, deadline=1e9,
                        times=RoundTimeModel(dist="fixed", mean_s=1.0))
    ref = Marina(binclass_grad, RandK(k=3), 0.05, 0.3, carry=True)
    sa, ma = run_states(dm, tdata, 15)
    sb, mb = run_states(ref, tdata, 15)
    for a, b in zip(sa, sb):
        assert torch.equal(a.params, b.params) and torch.equal(a.g, b.g)
    assert [m.bits_per_worker for m in ma] == [m.bits_per_worker for m in mb]
    assert {m.sync_round for m in ma} == {0, 1}


def test_static_slow_set_bit_identical_to_drop_fault(data):
    _, tdata = data
    slow = (1, 3)
    dm = DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3, deadline=2.0,
                        times=RoundTimeModel(dist="fixed", mean_s=1.0, slow_ids=slow,
                                             slow_factor=8.0))
    assert dm.static_miss_faults() == FaultSpec("drop", ids=slow)
    ref = Marina(binclass_grad, RandK(k=3), 0.05, 0.3, carry=True,
                 faults=FaultSpec("drop", ids=slow))
    sa, ma = run_states(dm, tdata, 15)
    sb, mb = run_states(ref, tdata, 15)
    for a, b in zip(sa, sb):
        assert torch.equal(a.params, b.params) and torch.equal(a.g, b.g)
        assert torch.equal(a.h, b.h)
    assert [m.bits_per_worker for m in ma] == [m.bits_per_worker for m in mb]
    assert any(m.uploaded == N - 2 for m in ma)


TIMES = {
    "lognormal": (dict(dist="lognormal", mean_s=1.0, sigma=0.6), 0.7, 2),
    "exponential": (dict(dist="exponential", mean_s=1.0), 0.6, 1),
    "fixed_slow": (dict(dist="fixed", mean_s=1.0, slow_ids=(0, 3), slow_factor=2.5), None, 2),
}


@pytest.mark.parametrize("times", list(TIMES))
def test_deadline_trajectory_equals_reference(data, times):
    jdata, tdata = data
    kw, q, tau_max = TIMES[times]
    jt, tt = JRoundTimeModel(**kw), RoundTimeModel(**kw)
    deadline = 1.0 if q is None else tt.deadline_for_quantile(q)
    assert deadline == (1.0 if q is None else jt.deadline_for_quantile(q))
    jm = JDeadlineMarina(jax.grad(j_loss), JRandK(k=4), 0.05, 0.3, deadline=deadline,
                         times=jt, tau_max=tau_max)
    tm = DeadlineMarina(binclass_grad, RandK(k=4), 0.05, 0.3, deadline=deadline,
                        times=tt, tau_max=tau_max)
    js, ts = jm.init(jnp.zeros((D,)), jdata), tm.init(torch.zeros(D), tdata)
    jstep = jax.jit(jm.step)
    uploads = set()
    for k in range(15):
        key = jax.random.PRNGKey(300_000 + k)
        draws = np.asarray(jt.sample(jax.random.fold_in(key, J_TIME_FOLD), N))
        assert (np.abs(draws / np.float32(deadline) - 1) > 1e-4).all() or q is None
        js, jmet = jstep(js, key, jdata)
        ts, tmet = tm.step(ts, prng.PRNGKey(300_000 + k), tdata)
        assert (tmet.sync_round, tmet.uploaded, tmet.staleness_max, tmet.bits_per_worker,
                tmet.down_bits) == (int(jmet.sync_round), int(jmet.uploaded),
                                    int(jmet.staleness_max), float(jmet.bits_per_worker),
                                    float(jmet.down_bits))
        assert tmet.staleness_mean == float(jmet.staleness_mean)
        assert ulp_diff(np.float32(tmet.wall_clock_s), np.asarray(jmet.wall_clock_s)) <= 4
        for name in ("tag", "arrive", "born"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ts.g.numpy(), np.asarray(js.g), rtol=1e-5, atol=1e-6)
        uploads.add(tmet.uploaded)
    assert len(uploads) > 1  # some rounds lost uploads to the deadline


def test_late_upload_lands_and_refreshes_anchor(data):
    _, tdata = data
    tm = RoundTimeModel(dist="fixed", mean_s=1.0, slow_ids=(0,), slow_factor=3.0)
    m = DeadlineMarina(binclass_grad, RandK(k=3), 0.05, p=1e-9, deadline=1.0, times=tm,
                       tau_max=2)
    states, metrics = run_states(m, tdata, 6)
    assert [mt.uploaded for mt in metrics] == [N - 1, N - 1, N, N - 1, N - 1, N]
    assert all(mt.wall_clock_s == 1.0 for mt in metrics)
    assert metrics[2].staleness_max == 2
    assert int(states[0].tag[0]) == -1 and int(states[1].tag[0]) == -1
    assert int(states[2].tag[0]) == 0 and int(states[2].arrive[0]) == -1


def test_all_on_time_round_closes_at_slowest_upload_and_sync_is_a_rendezvous(data):
    _, tdata = data
    m = DeadlineMarina(binclass_grad, RandK(k=3), 0.05, p=1e-9, deadline=1.0,
                       times=RoundTimeModel(dist="fixed", mean_s=0.7))
    _, metrics = run_states(m, tdata, 3)
    assert all(mt.wall_clock_s == pytest.approx(0.7) and mt.uploaded == N
               and mt.staleness_max == 0 for mt in metrics)
    tm = RoundTimeModel(dist="fixed", mean_s=1.0, slow_ids=(0,), slow_factor=3.0)
    m = DeadlineMarina(binclass_grad, RandK(k=3), 0.05, p=1.0 - 1e-9, deadline=1.0,
                       times=tm, tau_max=2)
    states, metrics = run_states(m, tdata, 2)
    for st, mt in zip(states, metrics):
        assert mt.sync_round == 1 and mt.uploaded == N
        assert (st.arrive == -1).all()
        assert mt.wall_clock_s == pytest.approx(3.0)
        assert mt.bits_per_worker == pytest.approx(32.0 * D)


def test_deadline_bits_scale_with_arrivals(data):
    _, tdata = data
    kw = dict(gamma=0.05, p=1e-9, deadline=2.0)
    full = DeadlineMarina(binclass_grad, RandK(k=3),
                          times=RoundTimeModel(dist="fixed", mean_s=1.0), **kw)
    slow = DeadlineMarina(binclass_grad, RandK(k=3), times=RoundTimeModel(
        dist="fixed", mean_s=1.0, slow_ids=(0, 2), slow_factor=8.0), **kw)
    _, mf = run_states(full, tdata, 4)
    _, ms = run_states(slow, tdata, 4)
    for f, s in zip(mf, ms):
        assert f.uploaded == N and s.uploaded == N - 2
        assert s.bits_per_worker == pytest.approx(f.bits_per_worker * (N - 2) / N)


def test_deadline_validation_and_static_reduction():
    with pytest.raises(ValueError, match="deadline"):
        DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3, deadline=0.0)
    with pytest.raises(ValueError, match="tau_max"):
        DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3, deadline=1.0, tau_max=-1)
    tm = RoundTimeModel(dist="fixed", slow_ids=(0,), slow_factor=8.0)
    assert DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3, deadline=2.0, times=tm,
                          tau_max=2).static_miss_faults() is None
    assert DeadlineMarina(binclass_grad, RandK(k=3), 0.05, 0.3,
                          deadline=2.0).static_miss_faults() is None


# ---------------------------------------------------------------------------
# RoundTimeModel
# ---------------------------------------------------------------------------


def test_roundtime_validation():
    assert TIME_FOLD == J_TIME_FOLD
    for kw, msg in (({"dist": "uniform"}, "dist"), ({"mean_s": 0.0}, "mean_s"),
                    ({"sigma": -0.1}, "sigma"),
                    ({"slow_ids": (0,), "slow_factor": 0.5}, "slow_factor"),
                    ({"slow_ids": (1, 1)}, "duplicates"),
                    ({"slow_ids": (-1,)}, "non-negative")):
        with pytest.raises(ValueError, match=msg):
            RoundTimeModel(**kw)


@pytest.mark.parametrize("dist", ["lognormal", "exponential", "fixed"])
def test_roundtime_samples_and_closed_forms_equal_reference(dist):
    kw = dict(dist=dist, mean_s=1.5, sigma=0.8, slow_ids=(1, 40), slow_factor=4.0)
    jt, tt = JRoundTimeModel(**kw), RoundTimeModel(**kw)
    for seed in (0, 1, 2**31 + 3):
        for n in (1, 5, 64):
            got = tt.sample(prng.PRNGKey(seed), n)
            want = np.asarray(jt.sample(jax.random.PRNGKey(seed), n))
            assert got.dtype == torch.float32
            assert ulp_diff(got, want) <= {"lognormal": 4, "exponential": 2, "fixed": 0}[dist]
    for q in (0.1, 0.5, 0.8, 0.95):
        assert tt.deadline_for_quantile(q) == jt.deadline_for_quantile(q)
    for dl in (0.0, 0.5, 1.5, 4.0):
        assert tt.miss_prob(dl) == jt.miss_prob(dl)
    with pytest.raises(ValueError, match="quantile"):
        tt.deadline_for_quantile(1.0)
    if dist != "fixed":
        t = tt.sample(prng.PRNGKey(1), 200_000).numpy()[2:]
        assert np.mean(t) == pytest.approx(1.5, rel=0.05)
        dl = tt.deadline_for_quantile(0.8)
        assert np.mean(t > dl) == pytest.approx(0.2, abs=0.01)
