"""MARINA trajectories of the port against the reference under the same keys.

On the eq. (11) binclass problem (n=4, d=512, B=128, kb=8), 20 rounds of
``Marina`` from the same data, start point and per-round keys: the ``c_k``
sequence and the bits ledger must be equal, params and the estimator g must
agree to rtol 1e-5 (torch and XLA reduce the gradient's matmuls in different
orders; the kernels themselves keep 1 ulp). Covered: the flat engine with
recompute and carry rounds, and the per-leaf tree path with RandK and
BlockRandK.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core import RandK as JRandK
from repro.core.flat import make_engine as j_make_engine
from repro.core.problems import binclass_smoothness as j_smoothness
from repro.core.problems import make_synthetic_binclass as j_make_binclass
from repro.core.problems import nonconvex_binclass_loss as j_loss
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import BlockRandK, Marina, RandK, make_engine
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
    return jdata, params_from_jax(jax.tree.map(np.asarray, jdata))


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


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("kind", ["engine", "randk", "block_randk"])
def test_binclass_trajectory_equals_reference(data, kind, carry):
    jdata, tdata = data
    jm, tm = _pair(kind, carry)
    x0 = np.zeros((D,), np.float32)
    js = jm.init(jnp.asarray(x0), jdata)
    ts = tm.init(torch.from_numpy(x0), tdata)
    jstep = jax.jit(jm.step)
    kinds = set()
    for k in range(ROUNDS):
        js, jmet = jstep(js, jax.random.PRNGKey(100 + k), jdata)
        ts, tmet = tm.step(ts, prng.PRNGKey(100 + k), tdata)
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
    a = make_synthetic_binclass(3, 2, 8, 16)
    b = make_synthetic_binclass(3, 2, 8, 16)
    assert a.a.shape == (2, 8, 16) and torch.equal(a.a, b.a) and torch.equal(a.y, b.y)
    assert set(torch.unique(a.y).tolist()) <= {-1.0, 1.0}
