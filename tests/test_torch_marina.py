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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core import PermK as JPermK
from repro.core import PPMarina as JPPMarina
from repro.core import RandK as JRandK
from repro.core import VRMarina as JVRMarina
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import binclass_smoothness as j_smoothness
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    BlockRandK,
    Marina,
    PermK,
    PPMarina,
    RandK,
    VRMarina,
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
