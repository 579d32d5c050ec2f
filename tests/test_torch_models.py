"""The port's dense LM against ``repro.models`` on a reduced config (2 layers,
d_model 64, 4 heads, 2 kv heads, vocab 256, seq 16), with the reference's
parameters carried across by ``convert.params_from_jax``:

* ``lm_loss`` and its gradient agree to rtol 1e-5 / atol 1e-6 (torch and
  XLA reduce matmuls in different orders — not a fault of the port), with
  and without a ``prefix_embed`` before the tokens (the loss over token
  positions only);
* 5 rounds of ``Marina`` on the flat engine with 2 workers and the
  reference's token batches agree to rtol 1e-4 of each leaf's scale, in both
  round shapes, with equal ``c_k`` and bits. (A compressed round uplinks
  Δ = ∇f(x_new) − ∇f(x_old), a difference of nearly equal gradients scaled
  by B/kb: the matmul-order noise of the two gradients is amplified in
  Δ's small entries, so the bound is held per leaf, relative to the leaf's
  largest magnitude; the worst such error measured is 1.5e-5.)
* 5 carry rounds of ``VRMarina`` on the permk wire (2 workers, minibatches
  of one sequence) and of ``PPMarina`` on the block_randk wire (4 clients,
  r = 2, the full carry table carried across), held the same way.
* 5 carry rounds of ``Marina`` on the packed QSGD wire (s = 7) and on
  block_randk under a QSGD downlink, held round by round from the
  reference's state (a level flip, once made, would move every later
  round — ROADMAP C): c_k, up and down bits equal; params and g leafwise
  within 1e-4 of the leaf's scale except at flagged coordinates, which lie
  within one quantization step (γ times it for params) and number at most
  1e-3 of all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core import PermK as JPermK
from repro.core import PPMarina as JPPMarina
from repro.core import VRMarina as JVRMarina
from repro.core import BlockQSGD as JBlockQSGD
from repro.core.flat import make_downlink as j_make_downlink
from repro.core.flat import make_engine as j_make_engine
from repro.data import HeterogeneousLMData as JData
from repro.data import worker_batches as j_worker_batches
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_stack as j_dense_stack
from repro_torch import prng
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import (
    BlockQSGD,
    BlockRandK,
    Marina,
    PermK,
    PPMarina,
    VRMarina,
    make_downlink,
    make_engine,
)
from repro_torch.core import flat as tflat
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.models import ModelConfig, dense_stack, lm_loss

CFG_KW = dict(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
              tie_embeddings=True, rope_theta=1_000_000.0, remat=False)
JCFG = JModelConfig(segments=j_dense_stack(2), **CFG_KW)
TCFG = ModelConfig(segments=dense_stack(2), **CFG_KW)
SEQ = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tokens():
    """The reference's (2 workers, 2, SEQ) token batches of steps 0..5."""
    data = JData(n_workers=2, vocab_size=256, seq_len=SEQ, seed=3)
    fn = jax.jit(lambda s: j_worker_batches(data, s, 2))
    return [np.asarray(fn(s)) for s in range(6)]


@pytest.fixture(scope="module")
def mb_tokens():
    """The reference's (2 workers, 1, SEQ) minibatches: the trainer's VR
    stream at steps 10**7 + 0..5."""
    data = JData(n_workers=2, vocab_size=256, seq_len=SEQ, seed=3)
    fn = jax.jit(lambda s: j_worker_batches(data, s, 1))
    return [np.asarray(fn(10**7 + s)) for s in range(6)]


@pytest.fixture(scope="module")
def tokens4():
    """The reference's (4 clients, 2, SEQ) token batches of steps 0..5."""
    data = JData(n_workers=4, vocab_size=256, seq_len=SEQ, seed=5)
    fn = jax.jit(lambda s: j_worker_batches(data, s, 2))
    return [np.asarray(fn(s)) for s in range(6)]


def _torch_grad(params, tokens, prefix=None):
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = lm_loss(tree_unflatten(treedef, leaves), TCFG, tokens, prefix)
    return loss, tree_unflatten(treedef, torch.autograd.grad(loss, leaves))


def _close_to_leaf_scale(a, b, rtol):
    b = np.asarray(b)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * scale)


def test_lm_loss_and_grad_match_reference(jparams, tokens):
    _loss_and_grad_match(jparams, tokens[0][0], None)


@pytest.mark.parametrize("prefix_len", [1, 3])
def test_lm_loss_with_prefix_embed_matches_reference(jparams, tokens, prefix_len):
    toks = tokens[0][0]
    prefix = np.random.default_rng(prefix_len).standard_normal(
        (toks.shape[0], prefix_len, CFG_KW["d_model"])).astype(np.float32) * 0.02
    _loss_and_grad_match(jparams, toks, prefix)


def _loss_and_grad_match(jparams, toks, prefix):
    jl, jg = jax.jit(jax.value_and_grad(j_lm_loss), static_argnums=1)(
        jparams, JCFG, jnp.asarray(toks), None if prefix is None else jnp.asarray(prefix))
    tl, tg = _torch_grad(params_from_jax(_np_tree(jparams), device="cpu"),
                         torch.tensor(toks), None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tree_leaves(tg))
    for a, b in zip(tree_leaves(tg), jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


_jgrad = jax.grad(lambda p, b: j_lm_loss(p, JCFG, b["tokens"]))


def _tgrad(p, b):
    return _torch_grad(p, b["tokens"])[1]


def _rounds_match(jm, tm, jparams, init_toks, step_toks, rounds=5):
    """Init the reference on ``init_toks``, carry its state (params, g, h)
    across, then run both packages under the same keys: round k takes the
    token batches ``step_toks(k)`` (a tuple, one per oracle). c_k and bits
    equal; params and g leafwise within 1e-4 of each leaf's scale."""
    js = jax.jit(jm.init)(jparams, {"tokens": jnp.asarray(init_toks)})
    ts = state_from_jax(_np_tree(js.params), _np_tree(js.g), 0,
                        None if js.h is None else _np_tree(js.h), device="cpu")
    jstep = jax.jit(jm.step)
    kinds = set()
    for k in range(rounds):
        toks = step_toks(k)
        key = jax.random.fold_in(jax.random.PRNGKey(7), k)
        js, jmet = jstep(js, key, *({"tokens": jnp.asarray(t)} for t in toks))
        ts, tmet = tm.step(ts, prng.fold_in(prng.PRNGKey(7), k),
                           *({"tokens": torch.tensor(t)} for t in toks))
        assert tmet.sync_round == int(jmet.sync_round)
        assert tmet.bits_per_worker == float(jmet.bits_per_worker)
        kinds.add(tmet.sync_round)
        for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(js.params)):
            _close_to_leaf_scale(a, b, 1e-4)
        for a, b in zip(tree_leaves(ts.g), jax.tree.leaves(js.g)):
            _close_to_leaf_scale(a, b, 1e-4)
    assert kinds == {0, 1}


def _pair(jparams, jm_cls, tm_cls, jcomp, tcomp, sampler, *args, **kw):
    """The reference optimizer and the port's on the same wire, engines
    built from the reference's parameters."""
    kb = {"kb": 8} if sampler == "randk" else {}
    jeng = j_make_engine(jparams, block=128, backend="ref", sampler=sampler, **kb)
    tp = params_from_jax(_np_tree(jparams), device="cpu")
    teng = make_engine(tp, block=128, device="cpu", sampler=sampler, **kb)
    jm = jm_cls(*args[0], jcomp, gamma=0.05, p=0.4, engine=jeng, **kw)
    tm = tm_cls(*args[1], tcomp, gamma=0.05, p=0.4, engine=teng, **kw)
    return jm, tm


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_lm_marina_rounds_match_reference(jparams, tokens, carry):
    jm, tm = _pair(jparams, JMarina, Marina, JBlockRandK(kb=8, block=128),
                   BlockRandK(kb=8, block=128), "randk", (_jgrad,), (_tgrad,),
                   carry=carry)
    _rounds_match(jm, tm, jparams, tokens[0], lambda k: (tokens[k + 1],))


def test_lm_vr_marina_permk_carry_matches_reference(jparams, tokens, mb_tokens):
    jm, tm = _pair(jparams, JVRMarina, VRMarina, JPermK(n=2, block=128),
                   PermK(n=2, block=128), "permk", (_jgrad, _jgrad),
                   (_tgrad, _tgrad), carry=True)
    _rounds_match(jm, tm, jparams, tokens[0],
                  lambda k: (tokens[k + 1], mb_tokens[k + 1]))


def test_lm_pp_marina_randk_carry_matches_reference(jparams, tokens4):
    """r = 2 of 4 clients, i.i.d. cohorts: the server's n-row carry table
    starts as the reference's own."""
    jm, tm = _pair(jparams, JPPMarina, PPMarina, JBlockRandK(kb=8, block=128),
                   BlockRandK(kb=8, block=128), "randk", (_jgrad,), (_tgrad,),
                   r=2, carry=True)
    _rounds_match(jm, tm, jparams, tokens4[0], lambda k: (tokens4[k + 1],))


def _leaf_close_except_flips(a, b, rtol, step) -> int:
    """Within rtol of the leaf's scale, except at flagged coordinates, which
    must lie within ``step`` of the reference; returns how many."""
    a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
    tol = rtol * (float(np.max(np.abs(b))) if b.size else 0.0)
    err = np.abs(a - b)
    flagged = err > tol
    assert (err[flagged] <= step * (1 + 1e-4) + tol).all(), (err.max(), tol, step)
    return int(flagged.sum())


@pytest.mark.parametrize("wire_kind", ["qsgd", "downlink"])
def test_lm_marina_quantized_carry_rounds_match_reference(jparams, tokens, wire_kind,
                                                           monkeypatch):
    tp = params_from_jax(_np_tree(jparams), device="cpu")
    if wire_kind == "qsgd":
        jc, tc = JBlockQSGD(s=7, block=128), BlockQSGD(s=7, block=128)
        jeng = j_make_engine(jparams, block=128, backend="ref", sampler="qsgd", s=7)
        teng = make_engine(tp, block=128, device="cpu", sampler="qsgd", s=7)
        jdown = tdown = None
    else:
        jc, tc = JBlockRandK(kb=8, block=128), BlockRandK(kb=8, block=128)
        jeng = j_make_engine(jparams, kb=8, block=128, backend="ref")
        teng = make_engine(tp, kb=8, block=128, device="cpu")
        jdown = j_make_downlink(jeng, sampler="qsgd", s=7)
        tdown = make_downlink(teng, sampler="qsgd", s=7)
    gamma = 0.05
    jm = JMarina(_jgrad, jc, gamma=gamma, p=0.4, engine=jeng, carry=True,
                 down_engine=jdown)
    tm = Marina(_tgrad, tc, gamma=gamma, p=0.4, engine=teng, carry=True,
                down_engine=tdown)
    steps = []
    encode = tflat.FlatEngine.encode_rows

    def recording(self, key, bufs, rows, n):
        payload = encode(self, key, bufs, rows, n)
        if "norms" in payload:
            steps.append(float(payload["norms"].max()) / (self.s * n))
        return payload

    monkeypatch.setattr(tflat.FlatEngine, "encode_rows", recording)
    js = jax.jit(jm.init)(jparams, {"tokens": jnp.asarray(tokens[0])})
    jstep = jax.jit(jm.step)
    kinds, flagged, compared = set(), 0, 0
    for k in range(5):
        ts = state_from_jax(_np_tree(js.params), _np_tree(js.g), k, _np_tree(js.h),
                            device="cpu")
        steps.clear()
        key = jax.random.fold_in(jax.random.PRNGKey(7), k)
        js, jmet = jstep(js, key, {"tokens": jnp.asarray(tokens[k + 1])})
        ts, tmet = tm.step(ts, prng.fold_in(prng.PRNGKey(7), k),
                           {"tokens": torch.tensor(tokens[k + 1])})
        assert (tmet.sync_round, tmet.bits_per_worker, tmet.down_bits) == (
            int(jmet.sync_round), float(jmet.bits_per_worker), float(jmet.down_bits))
        kinds.add(tmet.sync_round)
        step = sum(steps)
        for a, b in zip(tree_leaves(ts.params), jax.tree.leaves(js.params)):
            flagged += _leaf_close_except_flips(a, b, 1e-4, gamma * step)
            compared += a.numel()
        flagged += _leaf_close_except_flips(ts.g, js.g, 1e-4, step)
        compared += ts.g.numel()
    assert kinds == {0, 1}
    assert flagged <= 1e-3 * compared
