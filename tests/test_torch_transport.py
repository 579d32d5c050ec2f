"""The port's transport layer against the reference's, on the same inputs.

The reference's ``make_transport`` runs on a one-device mesh with Auto axes
(``jax.make_mesh`` builds Explicit axes under JAX 0.9, and the reference's
``with_sharding_constraint`` refuses those: ROADMAP C), with n = 4 payload
rows, called directly outside ``jit`` as ``tests/test_async.py`` calls it.
The port's transport runs on a CPU mesh without a process group (one
process hosting all four workers).

* ``uplink_mean``: randk, packed randk (int16 offsets, and int32 past L =
  32767), shared mask and permk (with the L % n ≠ 0 fallback) bit-equal;
  qsgd (int8 levels, and the 4-bit nibble wire) within ROADMAP C's QSGD
  bounds: levels bit-equal given the reference's row norms, the norms
  within 5 ulp, the dequant-mean within its rounding bound; PP cohort rows
  (``rows_n``, ``rows_sharded=False``) and ``uploaded_rows`` scaling.
* ``worker_rows`` (randk bit-equal, qsgd within the same bounds),
  ``downlink`` (randk bit-equal; qsgd within the bounds) and
  ``sync_aggregate`` (the mean within rtol 1e-6; a trimmed mean bit-equal).
* The ledgers equal scope by scope, bit for bit, for every call above.
* The three ``RetryPolicy`` / ``retry_call`` contracts of
  ``tests/test_async.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_parity import one_torch_thread, to_np, ulp_diff  # noqa: F401
from repro.core import ServerAggregator as JAggregator
from repro.launch.topology import detect_topology as j_detect_topology
from repro.launch.transport import make_transport as j_make_transport
from repro_torch import prng
from repro_torch.core import ServerAggregator
from repro_torch.launch import topology as topo
from repro_torch.launch.transport import RetryPolicy, make_transport, retry_call

N = 4
#: leaf (rows, *shape) shapes: a 3-d leaf with L = 40 (kb 1; PermK and
#: the nibble wire apply), L = 302 (kb 2; L % 8 ≠ 0 and L % n ≠ 0: the int8
#: QSGD wire and PermK's fallback), L = 33,000 (kb 257; int32 offsets on the
#: packed wire)
SHAPES = {"a": (N, 2, 3, 40), "b": (N, 302), "d": (N, 1, 33000)}


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))


@pytest.fixture(scope="module")
def tmesh():
    return topo.make_test_mesh(N, 1, device="cpu")


def _diffs(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in SHAPES.items()}


def _transports(jmesh, tmesh, **kw):
    repl = {k: NamedSharding(jmesh, P()) for k in SHAPES}
    jt = j_make_transport(jmesh, j_detect_topology(jmesh), waxes=("data",), n=N,
                          param_shardings=repl, **kw)
    tt = make_transport(tmesh, topo.detect_topology(tmesh), waxes=("data",), n=N, **kw)
    return jt, tt


def _tree(d, fn):
    return {k: fn(v) for k, v in d.items()}


def _ledgers_equal(jt, tt):
    assert tt.ledger.bits == jt.ledger.bits
    assert tt.ledger.counts == jt.ledger.counts


UPLINKS = {
    "randk": {},
    "randk_packed": {"packed_payload": True},
    "shared_mask": {"shared_mask": True},
    "permk": {"compression": "permk"},
    "permk_packed": {"compression": "permk", "packed_payload": True},
}


@pytest.mark.parametrize("name", list(UPLINKS))
def test_uplink_mean_bit_equal(jmesh, tmesh, name):
    jt, tt = _transports(jmesh, tmesh, **UPLINKS[name])
    x = _diffs()
    key = 11
    with jt.scope("compressed_step"):
        want = jt.uplink_mean(jax.random.PRNGKey(key), _tree(x, jnp.asarray))
    with tt.scope("compressed_step"):
        got = tt.uplink_mean(prng.PRNGKey(key), _tree(x, torch.from_numpy))
    for k in SHAPES:
        assert got[k].shape == SHAPES[k][1:]
        assert ulp_diff(got[k], want[k]) == 0, k
    _ledgers_equal(jt, tt)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "nibble"])
def test_uplink_mean_qsgd_within_the_qsgd_bounds(jmesh, tmesh, packed):
    """Levels bit-equal given the reference's norms; the row norms within 5
    ulp; the mean within 2(n+3)·2^-24·Σ|terms|/n of the reference's (its
    dequant-mean loop compiles to an FMA, ROADMAP C)."""
    from repro.launch.transport import _qsgd_quantize_rows as jq

    from repro_torch.launch.transport import _qsgd_quantize_rows as tq

    s = 7
    jt, tt = _transports(jmesh, tmesh, compression="qsgd", qsgd_s=s, packed_payload=packed)
    x = _diffs(1)
    with jt.scope("compressed_step"):
        want = jt.uplink_mean(jax.random.PRNGKey(5), _tree(x, jnp.asarray))
    with tt.scope("compressed_step"):
        got = tt.uplink_mean(prng.PRNGKey(5), _tree(x, torch.from_numpy))
    _ledgers_equal(jt, tt)
    keys = jax.random.split(jax.random.PRNGKey(5), len(SHAPES))
    for lk, k in zip(keys, sorted(SHAPES)):
        shape = SHAPES[k][1:]
        L = shape[-1]
        R = int(np.prod(shape[:-1]))
        xr = x[k].reshape(N, R, L)
        jl, jn = jq(lk, jnp.asarray(xr), s)
        u = prng.uniform(np.asarray(lk), (N, R, L), device="cpu")
        tl, tn = tq(u, torch.from_numpy(xr), s)
        assert ulp_diff(tn, jn) <= 5
        # levels given the reference's norms: the port's formula, the same dither
        xf = torch.from_numpy(xr)
        jn_t = torch.from_numpy(np.array(jn))
        safe = torch.where(jn_t > 0, jn_t, torch.ones_like(jn_t))
        lv = (torch.sign(xf) * torch.floor(s * torch.abs(xf) / safe + u)).to(torch.int8)
        assert torch.equal(lv, torch.from_numpy(np.asarray(jl)))
        terms = np.abs(np.asarray(jl, np.float64)) * np.asarray(jn, np.float64) / s
        bound = 2 * (N + 3) * 2.0**-24 * terms.sum(0).reshape(shape) / N
        flips = np.abs(to_np(got[k]) - to_np(want[k])) > bound + 1e-30
        # a level may flip only where the port's norm moved the floor argument
        # across an integer: at most one level step there
        step = np.asarray(jn).max() / s / N
        assert flips.mean() <= 1e-3
        assert np.all(np.abs(to_np(got[k]) - to_np(want[k]))[flips] <= step * (1 + 1e-4))


def test_uplink_rows_and_uploaded_rows(jmesh, tmesh):
    """PP cohort rows (r of n staged on every rank) bit-equal, and
    ``uploaded_rows`` = None / 4 / 2 / 0 books 1, 1, ½, 0 of the uplink; a
    count past n raises as the reference's does."""
    jt, tt = _transports(jmesh, tmesh)
    x = {k: v[:2] for k, v in _diffs(2).items()}
    with jt.scope("compressed_step"):
        want = jt.uplink_mean(jax.random.PRNGKey(3), _tree(x, jnp.asarray), rows_n=2,
                              rows_sharded=False)
    with tt.scope("compressed_step"):
        got = tt.uplink_mean(prng.PRNGKey(3), _tree(x, torch.from_numpy), rows_n=2,
                             rows_sharded=False)
    for k in SHAPES:
        assert ulp_diff(got[k], want[k]) == 0
    _ledgers_equal(jt, tt)
    full = _diffs(3)
    booked = []
    for u in (None, 4, 2, 0):
        jt, tt = _transports(jmesh, tmesh)
        jt.uplink_mean(jax.random.PRNGKey(1), _tree(full, jnp.asarray), uploaded_rows=u)
        tt.uplink_mean(prng.PRNGKey(1), _tree(full, torch.from_numpy), uploaded_rows=u)
        _ledgers_equal(jt, tt)
        booked.append(tt.ledger.total_bits(direction="up"))
    assert booked[0] > 0 and booked[1] == booked[0]
    assert booked[2] == pytest.approx(booked[0] / 2) and booked[3] == 0.0
    with pytest.raises(ValueError, match="uploaded_rows"):
        tt.uplink_mean(prng.PRNGKey(1), _tree(full, torch.from_numpy), uploaded_rows=5)


@pytest.mark.parametrize("compression", ["randk", "qsgd"])
def test_worker_rows(jmesh, tmesh, compression):
    kw = {"compression": compression, "qsgd_s": 7, "packed_payload": compression == "qsgd"}
    jt, tt = _transports(jmesh, tmesh, **kw)
    x = _diffs(4)
    with jt.scope("compressed_step"):
        want = jt.worker_rows(jax.random.PRNGKey(9), _tree(x, jnp.asarray), N, uploaded_rows=3)
    with tt.scope("compressed_step"):
        got = tt.worker_rows(prng.PRNGKey(9), _tree(x, torch.from_numpy), N, uploaded_rows=3)
    _ledgers_equal(jt, tt)
    for k in SHAPES:
        assert got[k].shape == SHAPES[k]
        if compression == "randk":
            assert ulp_diff(got[k], want[k]) == 0
        else:  # levels given the port's norms: a row's value moves with its norm
            w = to_np(want[k]).reshape(N, -1)
            err = np.abs(to_np(got[k]).reshape(N, -1) - w)
            scale = np.abs(w).max(axis=1, keepdims=True)
            assert np.mean(err > 5 * 2.0**-23 * scale) <= 1e-3


@pytest.mark.parametrize("mode", ["randk", "qsgd", "none"])
def test_downlink(jmesh, tmesh, mode):
    jt, tt = _transports(jmesh, tmesh, downlink=mode, downlink_s=7, packed_payload=True)
    delta = {k: v[0] for k, v in _diffs(5).items()}
    with jt.scope("compressed_step"):
        want = jt.downlink(jax.random.PRNGKey(8), _tree(delta, jnp.asarray))
    with tt.scope("compressed_step"):
        got = tt.downlink(prng.PRNGKey(8), _tree(delta, torch.from_numpy))
    _ledgers_equal(jt, tt)
    for k in SHAPES:
        if mode == "qsgd":
            w = to_np(want[k])
            err = np.abs(to_np(got[k]) - w)
            assert np.mean(err > 5 * 2.0**-23 * np.abs(w).max()) <= 1e-3
        else:
            assert ulp_diff(got[k], want[k]) == 0


@pytest.mark.parametrize("rule", ["mean", "trimmed_mean"])
def test_sync_aggregate(jmesh, tmesh, rule):
    jt, tt = _transports(jmesh, tmesh)
    x = _diffs(6)
    with jt.scope("sync_step"):
        want = jt.sync_aggregate(_tree(x, jnp.asarray), JAggregator(rule, f=1))
    with tt.scope("sync_step"):
        got = tt.sync_aggregate(_tree(x, torch.from_numpy), ServerAggregator(rule, f=1))
    _ledgers_equal(jt, tt)
    for k in SHAPES:
        if rule == "mean":
            np.testing.assert_allclose(to_np(got[k]), to_np(want[k]), rtol=1e-6, atol=1e-7)
        else:
            assert ulp_diff(got[k], want[k]) == 0


def test_retry_policy_validation_and_backoff():
    p = RetryPolicy(timeout_s=10.0, retries=3, backoff_s=0.5, backoff_mult=2.0)
    assert [p.backoff(a) for a in range(3)] == [0.5, 1.0, 2.0]
    for bad in (dict(timeout_s=0.0), dict(retries=-1), dict(backoff_s=-1.0),
                dict(backoff_mult=0.5)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def test_retry_call_retries_then_succeeds():
    calls, sleeps, retries = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    policy = RetryPolicy(retries=2, backoff_s=1.0, backoff_mult=3.0)
    out = retry_call(flaky, policy, retryable=(OSError,),
                     on_retry=lambda a, e: retries.append((a, str(e))), sleep=sleeps.append)
    assert out == "ok" and len(calls) == 3
    assert sleeps == [1.0, 3.0]
    assert retries == [(0, "transient"), (1, "transient")]


def test_retry_call_exhaustion_and_nonretryable():
    policy = RetryPolicy(retries=1, backoff_s=0.0)
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("down")), policy,
                   retryable=(OSError,), sleep=lambda s: None)
    with pytest.raises(KeyError):
        retry_call(lambda: {}["x"], policy, retryable=(OSError,), sleep=lambda s: None)
