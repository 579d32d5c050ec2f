"""The port's ``core/problems.py`` against ``repro.core.problems``.

* On the reference's arrays carried across: ``quadratic_loss``,
  ``quad_optimum``, ``binclass_full_grad`` and ``gradient_heterogeneity``
  agree to rtol 1e-5 (torch and XLA reduce in different orders);
  ``sample_minibatch`` draws the reference's rows bit for bit under the same
  key.
* The port's makers keep the reference's invariants on their own draws:
  every spectrum in [1/κ, 1]; ``make_quadratic`` returns L and µ of the mean
  matrix; ``make_shifted_quadratics`` shares one A, and its gradient
  dissimilarity is ζ² at every x (to f32 rounding); ``make_dirichlet_binclass``
  gives ±1 labels, the uniform mixture for α = None or ∞, and more
  dissimilar clients at α = 0.1 than at ∞.
* MARINA on the reference's shifted quadratics and PP-MARINA (r = 2 of 6,
  without replacement) on its Dirichlet binclass split, both round shapes,
  30 rounds under the same keys: c_k and bits equal, oracle calls equal
  once rounded to float32 (the reference books r/n in float32), params and
  g within rtol 1e-5 every round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core import Marina as JMarina
from repro.core import PPMarina as JPPMarina
from repro.core import RandK as JRandK
from repro.core import problems as jp
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import Marina, PPMarina, RandK, pp_marina_gamma
from repro_torch.core import problems as tp

ROUNDS = 30


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _quad(jdata) -> tp.QuadData:
    return tp.QuadData(*params_from_jax(tuple(_np(jdata)), device="cpu"))


def _binclass(jdata) -> tp.BinClassData:
    return tp.BinClassData(*params_from_jax(tuple(_np(jdata)), device="cpu"))


def _quad_grad(x, batch):
    x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(tp.quadratic_loss(x, batch), x)
    return g


@pytest.fixture(scope="module")
def jquad():
    return jp.make_quadratic(jax.random.PRNGKey(2), 4, 12, kappa=8.0)[0]


def test_quadratic_loss_and_optimum_match_reference(jquad):
    tdata = _quad(jquad)
    x = np.random.default_rng(0).standard_normal(12).astype(np.float32)
    for i in range(4):
        want = jp.quadratic_loss(jnp.asarray(x), jp.QuadData(jquad.A[i], jquad.b[i]))
        got = tp.quadratic_loss(torch.from_numpy(x), tp.QuadData(tdata.A[i], tdata.b[i]))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tp.quad_optimum(tdata).numpy(),
                               np.asarray(jp.quad_optimum(jquad)), rtol=1e-5, atol=1e-6)


def test_binclass_full_grad_and_heterogeneity_match_reference():
    jdata = jp.make_synthetic_binclass(jax.random.PRNGKey(0), 4, 32, 20)
    tdata = _binclass(jdata)
    x = np.random.default_rng(1).standard_normal(20).astype(np.float32) * 0.3
    flat_j = jp.BinClassData(jdata.a.reshape(-1, 20), jdata.y.reshape(-1))
    flat_t = tp.BinClassData(tdata.a.reshape(-1, 20), tdata.y.reshape(-1))
    np.testing.assert_allclose(tp.binclass_full_grad(torch.from_numpy(x), flat_t).numpy(),
                               np.asarray(jp.binclass_full_grad(jnp.asarray(x), flat_j)),
                               rtol=1e-5, atol=1e-7)
    jgrads = jax.vmap(jax.grad(jp.nonconvex_binclass_loss), in_axes=(None, 0))(
        jnp.asarray(x), jdata)
    np.testing.assert_allclose(
        float(tp.gradient_heterogeneity(torch.from_numpy(np.array(jgrads)))),
        float(jp.gradient_heterogeneity(jgrads)), rtol=1e-5)


@pytest.mark.parametrize("b", [1, 7, 64])
def test_sample_minibatch_bit_equal(b):
    jdata = jp.make_synthetic_binclass(jax.random.PRNGKey(3), 3, 40, 8)
    key = jax.random.fold_in(jax.random.PRNGKey(9), b)
    want = jp.sample_minibatch(key, jdata, b)
    got = tp.sample_minibatch(np.asarray(key), _binclass(jdata), b)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))


@pytest.mark.parametrize("kappa", [3.0, 8.0, 10.0])
def test_quadratic_makers_invariants(kappa):
    lo = float(np.float32(1.0 / kappa))
    data, L, mu = tp.make_quadratic(2, 4, 12, kappa=kappa, device="cpu")
    for A in data.A.double():
        torch.testing.assert_close(A, A.T, rtol=0, atol=1e-6)
        ev = torch.linalg.eigvalsh(A)
        assert lo * (1 - 1e-5) <= float(ev.min()) and float(ev.max()) <= 1 + 1e-5
    ev = torch.linalg.eigvalsh(torch.mean(data.A, 0))
    assert (L, mu) == (float(ev.max()), float(ev.min()))

    data, L, mu = tp.make_shifted_quadratics(3, 8, 12, zeta=2.0, kappa=kappa, device="cpu")
    assert (L, mu) == (1.0, lo)
    assert all(torch.equal(A, data.A[0]) for A in data.A)
    ev = torch.linalg.eigvalsh(data.A[0].double())
    assert lo * (1 - 1e-5) <= float(ev.min()) and float(ev.max()) <= 1 + 1e-5
    u = (data.b - data.b.mean(0)).double() / 2.0                # ζ·u_i = b_i − b̄
    np.testing.assert_allclose(float(torch.mean(torch.sum(u * u, -1))), 1.0, rtol=1e-6)


@pytest.mark.parametrize("zeta", [0.5, 2.0])
def test_shifted_quadratics_zeta_exact(zeta):
    data, _, _ = tp.make_shifted_quadratics(3, 8, 12, zeta=zeta, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        x = torch.randn(12, generator=gen)
        grads = torch.stack([_quad_grad(x, tp.QuadData(A, b))
                             for A, b in zip(data.A, data.b)])
        np.testing.assert_allclose(float(tp.gradient_heterogeneity(grads)), zeta**2,
                                   rtol=1e-5)


def test_dirichlet_binclass_invariants_and_alpha_dial():
    zs = {}
    for alpha in (0.1, np.inf, None):
        data = tp.make_dirichlet_binclass(5, 16, 64, 10, alpha=alpha, device="cpu")
        assert data.a.shape == (16, 64, 10) and data.y.shape == (16, 64)
        assert set(data.y.unique().tolist()) <= {-1.0, 1.0}
        x = torch.zeros(10)
        grads = torch.stack([tp.binclass_grad(x, tp.BinClassData(a, y))
                             for a, y in zip(data.a, data.y)])
        zs[alpha] = float(tp.gradient_heterogeneity(grads))
    assert zs[np.inf] == zs[None]  # both the uniform mixture
    assert zs[0.1] > 2.0 * zs[np.inf], zs


def _run_both(jm, tm, jdata, tdata, x0):
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
        np.testing.assert_allclose(ts.g.numpy(), np.asarray(js.g), rtol=1e-5, atol=1e-6)
    assert kinds == {0, 1}


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_marina_on_shifted_quadratics_matches_reference(carry):
    jdata, L, _ = jp.make_shifted_quadratics(jax.random.PRNGKey(2), 6, 16, zeta=1.0,
                                             kappa=5.0)
    jm = JMarina(jax.grad(jp.quadratic_loss), JRandK(k=4), gamma=0.5 / L, p=0.3,
                 carry=carry)
    tm = Marina(_quad_grad, RandK(k=4), gamma=0.5 / L, p=0.3, carry=carry)
    _run_both(jm, tm, jdata, _quad(jdata), np.ones(16, np.float32))


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_pp_marina_on_dirichlet_binclass_matches_reference(carry):
    jdata = jp.make_dirichlet_binclass(jax.random.PRNGKey(1), 6, 32, 12, alpha=0.3)
    L = jp.binclass_smoothness(jdata)
    comp = RandK(k=3)
    p = comp.default_p(12) * 2 / 6
    gamma = pp_marina_gamma(L, comp.omega(12), p, 2)
    jm = JPPMarina(jax.grad(jp.nonconvex_binclass_loss), JRandK(k=3), gamma, p, r=2,
                   replace=False, carry=carry)
    tm = PPMarina(tp.binclass_grad, comp, gamma, p, 2, replace=False, carry=carry)
    _run_both(jm, tm, jdata, _binclass(jdata), np.zeros(12, np.float32))
