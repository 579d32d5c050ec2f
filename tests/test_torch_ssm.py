"""The recurrent mixers of the port (``repro_torch.models.ssm``) against
``repro.models.ssm``, on the CPU, one mixer at a time, with the
reference's ``init_*`` weights carried across by ``convert.params_from_jax``
and numpy inputs from a seed (reduced recurrentgemma and xLSTM widths:
d_model 64, 4 heads; mLSTM hd 32, sLSTM hd 16):

* :func:`ssm.associative_scan` against ``jax.lax.associative_scan`` (eager)
  on the RG-LRU combine and on a sum, at every length to 64 and at 512 and
  2304: bit for bit, since both combine the same pairs in the same tree —
  once the port's subnormals are flushed to zero, as XLA on the CPU flushes
  them (the decay's running product underflows past ~300 steps; ROADMAP C's
  subnormal entry);
* ``jax.nn``'s GELU (tanh), softplus and SiLU and their gradients;
* each mixer's training output and the gradients of a random projection of
  it (every weight and the input) against ``jax.grad`` of the reference:
  RG-LRU at rtol 1e-5 / atol 1e-6 (ROADMAP C's first entry), mLSTM and
  sLSTM at rtol 1e-5 with an atol of 1e-5 of the array's largest magnitude
  (ROADMAP C, the xLSTM entry: against float64 both packages carry up to
  7.1e-6 of that scale, 3.1e-5 with saturated sLSTM gates, from the
  stabilized exponentials and the normalizer's division,
  ``scripts/xlstm_precision.py``); mLSTM at S = 40
  (one chunk) and S = 512 (two chunks of 256, so the boundary state hands
  over); sLSTM; and mLSTM and sLSTM with saturated gates (the gate weights
  ×300: log-gates in the hundreds, where the −inf of the causal mask and the
  −1e30 starting state meet the stabilizer) with finite gradients;
* the prefill state (RG-LRU's and sLSTM's scan carry, mLSTM's
  whole-sequence formula) against the reference's ``blocks._*_train``, then
  three decode cells from it: outputs and states;
* the chunk rule: S neither ≤ 256 nor a multiple of 256 is refused where
  the reference refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.models import blocks as jblocks
from repro.models import reduced as j_reduced
from repro.models import ssm as jssm
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm

RTOL, ATOL = 1e-5, 1e-6
#: the xLSTM mixers' atol, as a fraction of the array's largest magnitude
SCALE_ATOL = 1e-5
#: mixer → (architecture, reduced layers)
ARCH = {"rglru": ("recurrentgemma-2b", 3), "mlstm": ("xlstm-350m", 8),
        "slstm": ("xlstm-350m", 8)}
J_INIT = {"rglru": jssm.init_rglru, "mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}
J_TRAIN = {"rglru": jssm.rglru_train, "mlstm": jssm.mlstm_train,
           "slstm": jssm.slstm_train}
J_PREFILL = {"rglru": jblocks._rglru_train, "mlstm": jblocks._mlstm_train,
             "slstm": jblocks._slstm_train}
J_DECODE = {"rglru": jssm.rglru_decode, "mlstm": jssm.mlstm_decode,
            "slstm": jssm.slstm_decode}
T_TRAIN = {"rglru": ssm.rglru_train, "mlstm": ssm.mlstm_train, "slstm": ssm.slstm_train}
T_PREFILL = {"rglru": ssm.rglru_prefill, "mlstm": ssm.mlstm_prefill,
             "slstm": ssm.slstm_prefill}
T_DECODE = {"rglru": ssm.rglru_decode, "mlstm": ssm.mlstm_decode,
            "slstm": ssm.slstm_decode}
#: the gate weights a saturated case scales
GATES = {"mlstm": ("w_if",), "slstm": ("w_in", "r_i", "r_f")}


def _cfgs(mixer):
    arch, layers = ARCH[mixer]
    jcfg = j_reduced(j_get_arch(arch).model, layers=layers, d_model=64)
    return jcfg, port_cfg(jcfg)


def _weights(mixer, seed=0, gate_scale=1.0):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = _cfgs(mixer)
    jp = J_INIT[mixer](jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if gate_scale != 1.0:
        jp = dict(jp, **{k: jp[k] * gate_scale for k in GATES[mixer]})
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL, what="", scale=False):
    """Within rtol / atol, or with ``scale`` within rtol and an atol of
    ``SCALE_ATOL`` × the largest |want|."""
    want = np.asarray(want)
    if scale:
        atol = SCALE_ATOL * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _rglru_combine_j(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


def _ftz(t: torch.Tensor) -> np.ndarray:
    x = t.numpy()
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0), x)


@pytest.mark.parametrize("S", list(range(1, 65)) + [512, 2304])
def test_associative_scan_bit_equal_to_lax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32)
    b = rng.standard_normal((2, S, 3)).astype(np.float32)
    want = jax.lax.associative_scan(_rglru_combine_j, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm.associative_scan(ssm._rglru_combine, (torch.from_numpy(a), torch.from_numpy(b)),
                               axis=1)
    for g, w in zip(got, want):
        assert np.array_equal(_ftz(g), np.asarray(w))
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(b), axis=1)
    (got,) = ssm.associative_scan(lambda l, r: (l[0] + r[0],), (torch.from_numpy(b),), axis=1)
    assert np.array_equal(_ftz(got), np.asarray(want))


def test_elementwise_functions_match_jax():
    """GELU (tanh form), softplus (logaddexp(x, 0)), SiLU and the log
    forget gate (``F.logsigmoid`` against −softplus(−x)) on a grid with
    large, tiny and zero arguments: values within rtol 3e-7 and gradients
    within rtol 1e-6 (a few ulp: tanh, exp and log1p are each library's
    own; XLA's log1p is an approximation, ROADMAP C) or atol 1e-6 (GELU's 1 + tanh(·) cancels
    near −1, where an ulp of tanh is 6e-8 of a value near zero); GELU's
    gradient within atol 1e-5 (where one library's tanh reaches −1 an ulp
    earlier, its derivative x·(1 − tanh²)·… drops to 0: 3.8e-6 at
    x = −4.875)."""
    x = np.concatenate([np.linspace(-30, 30, 4001), [0.0, 1e-30, -1e-30, 88.0, -88.0, 200.0,
                                                     -200.0]]).astype(np.float32)
    for tfn, jfn in ((ssm.gelu, jax.nn.gelu), (ssm.softplus, jax.nn.softplus),
                     (ssm.silu, jax.nn.silu),
                     (torch.nn.functional.logsigmoid, lambda z: -jax.nn.softplus(-z))):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tfn(xt)
        (gt,) = torch.autograd.grad(y.sum(), xt)
        yj, vjp = jax.vjp(jfn, jnp.asarray(x))
        (gj,) = vjp(jnp.ones_like(yj))
        _close(y, yj, rtol=3e-7, atol=1e-6, what=tfn.__name__)
        _close(gt, gj, rtol=1e-6, atol=1e-5 if tfn is ssm.gelu else 1e-7,
               what=tfn.__name__)


#: case → (mixer, S, gate scale)
TRAIN_CASES = {
    "rglru": ("rglru", 37, 1.0),
    "rglru_s1": ("rglru", 1, 1.0),
    "mlstm": ("mlstm", 40, 1.0),
    "mlstm_two_chunks": ("mlstm", 512, 1.0),
    "mlstm_saturated": ("mlstm", 48, 300.0),
    "slstm": ("slstm", 24, 1.0),
    "slstm_saturated": ("slstm", 24, 300.0),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_mixer_train_output_and_grads_match_reference(case):
    mixer, S, scale = TRAIN_CASES[case]
    jcfg, tcfg, jp, tp = _weights(mixer, seed=1, gate_scale=scale)
    big = mixer != "rglru"
    rng = np.random.default_rng(2)
    B = 1 if S > 256 else 2
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(J_TRAIN[mixer](p, jcfg, xx) * proj)

    jy = J_TRAIN[mixer](jp, jcfg, jnp.asarray(x))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))

    names = sorted(tp)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items() if k != "conv"}
    if "conv" in tp:
        leaves["conv"] = {k: v.detach().requires_grad_(True) for k, v in tp["conv"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = T_TRAIN[mixer](leaves, tcfg, xt)
    _close(ty, jy, what=f"{case} output", scale=big)
    flat = [(k, leaves[k]) for k in names if k != "conv"]
    flat += [(f"conv.{k}", leaves["conv"][k]) for k in sorted(leaves.get("conv", {}))]
    grads = torch.autograd.grad((ty * torch.from_numpy(proj)).sum(), [t for _, t in flat] + [xt])
    for (name, _), g in zip(flat, grads):
        want = jgp["conv"][name[5:]] if name.startswith("conv.") else jgp[name]
        assert torch.isfinite(g).all(), f"{case}: {name} gradient not finite"
        _close(g, want, what=f"{case} d/d{name}", scale=big)
    _close(grads[-1], jgx, what=f"{case} d/dx", scale=big)
    if scale != 1.0:  # the saturated gates reach the stabilizer's extremes
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("mixer", sorted(ARCH))
def test_prefill_state_and_decode_cells_match_reference(mixer):
    jcfg, tcfg, jp, tp = _weights(mixer, seed=3)
    rng = np.random.default_rng(4)
    B, S = 2, 13
    x = rng.standard_normal((B, S + 3, jcfg.d_model)).astype(np.float32)
    jy, jstate = J_PREFILL[mixer](jp, jcfg, jnp.asarray(x[:, :S]), True)
    with torch.inference_mode():
        ty, tstate = T_PREFILL[mixer](tp, tcfg, torch.from_numpy(x[:, :S]))
    _close(ty, jy, what=f"{mixer} prefill output")
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        assert tuple(tstate[k].shape) == jstate[k].shape and str(tstate[k].dtype) == \
            f"torch.{jstate[k].dtype}"
        _close(tstate[k], jstate[k], what=f"{mixer} prefill state {k}")
    tstate = {k: v.clone() for k, v in tstate.items()}
    for t in range(S, S + 3):
        jo, jstate = J_DECODE[mixer](jp, jcfg, jstate, jnp.asarray(x[:, t:t + 1]))
        with torch.inference_mode():
            to, same = T_DECODE[mixer](tp, tcfg, tstate, torch.from_numpy(x[:, t:t + 1]))
        assert same is tstate  # the state is written in place
        _close(to, jo, what=f"{mixer} decode output at {t}")
        for k in jstate:
            _close(tstate[k], jstate[k], what=f"{mixer} decode state {k} at {t}")


@pytest.mark.parametrize("mixer", sorted(ARCH))
def test_initial_states_and_port_init_match_reference(mixer):
    """``init_*_state`` equals the reference's (zeros, m = −1e30); the port's
    own ``init_*`` has the reference's keys, shapes and dtypes, and lam is
    drawn in [0.7, 5.0)."""
    jcfg, tcfg = _cfgs(mixer)
    jstate = getattr(jssm, f"init_{mixer}_state")(jcfg, 3, jnp.float32)
    tstate = getattr(ssm, f"init_{mixer}_state")(tcfg, 3, torch.float32, "cpu")
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        assert np.array_equal(tstate[k].numpy(), np.asarray(jstate[k]))
    want = jax.eval_shape(lambda k: J_INIT[mixer](k, jcfg, jnp.float32), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    got = getattr(ssm, f"init_{mixer}")(gen, tcfg, torch.float32, "cpu")
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(np.asarray, got))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(jax.tree.map(np.asarray, got))):
        assert a.shape == b.shape and a.dtype == b.dtype
    if mixer == "rglru":
        assert 0.7 <= float(got["lam"].min()) and float(got["lam"].max()) < 5.0
    if mixer == "slstm":
        full = port_cfg(j_get_arch("xlstm-350m").model)
        jfull = jax.eval_shape(lambda k: jssm.init_slstm(
            k, j_get_arch("xlstm-350m").model, jnp.float32), jax.random.PRNGKey(0))
        assert ssm.slstm_ff_width(full) == 1408 == jfull["ff_down"].shape[0]


@pytest.mark.parametrize("S", [256, 300, 512, 600])
def test_mlstm_chunk_rule_refused_as_the_reference_refuses_it(S):
    jcfg, tcfg, jp, tp = _weights("mlstm")
    x = np.zeros((1, S, jcfg.d_model), np.float32)
    jshape = jax.eval_shape(lambda p, xx: jssm.mlstm_train(p, jcfg, xx), jp, x) \
        if S % 256 == 0 else None
    if jshape is None:
        with pytest.raises(AssertionError):
            jax.eval_shape(lambda p, xx: jssm.mlstm_train(p, jcfg, xx), jp, x)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssm.mlstm_train(tp, tcfg, torch.from_numpy(x))
    else:
        with torch.inference_mode():
            assert tuple(ssm.mlstm_train(tp, tcfg, torch.from_numpy(x)).shape) == jshape.shape
