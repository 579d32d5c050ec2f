"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, parameters made by the reference's
``init_moe`` and carried across by ``convert.params_from_jax``, inputs from
numpy under a seed:

* ``_route``: expert ids bit-equal and combine weights within rtol 1e-6
  (the aux loss too), for the softmax and the sigmoid router, on random
  inputs and on inputs built for exact ties (integer-valued logits, a
  zero router), where both take the lowest index first;
* ``capacity`` equal to the reference's over a grid of T, E, top_k and
  capacity_factor;
* ``moe_ff`` within rtol 1e-5 / atol 1e-6 of the reference's on drop-free
  inputs (both routers, with and without a shared expert);
* the two departures of ROADMAP C: with an expert forced to overflow, the
  outputs differ exactly on each overflowing expert's rank-0 token (the
  reference's dropped pairs overwrite that slot; the port keeps ranks
  0 … C−1) and agree everywhere else; and the combine is a gather, each
  token's top-k outputs × weights added in k order — equal to that sum in
  numpy on outputs where the order shows — and bit-identical run to run
  (on the card too: tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import dense_stack as j_dense_stack
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig

D = 16


def _cfgs(**moe_kw):
    """The reference's ModelConfig and the port's MoEConfig of one MoE."""
    kw = dict(num_experts=4, top_k=2, d_expert=24, num_shared=1, capacity_factor=4.0,
              router_score="softmax")
    kw.update(moe_kw)
    jcfg = JModelConfig(name="moe", arch_type="moe", d_model=D, num_heads=2,
                        num_kv_heads=2, d_ff=32, vocab_size=64,
                        segments=j_dense_stack(1, ff="moe"), moe=JMoEConfig(**kw))
    return jcfg, MoEConfig(**kw)


def _port_model_cfg(jcfg, tmoe):
    return dataclasses.replace(port_cfg(jcfg), moe=tmoe)


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(T, seed=1):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)


def _check_route(jp, tp, jcfg, tmoe, x):
    jids, jw, jaux = jmoe._route(jp, jcfg.moe, jnp.asarray(x))
    tids, tw, taux = moe._route(tp, tmoe, torch.from_numpy(x))
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    return tids.numpy()


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_reference(router, top_k):
    jcfg, tmoe = _cfgs(router_score=router, top_k=top_k, num_experts=6)
    jp, tp = _params(jcfg)
    _check_route(jp, tp, jcfg, tmoe, _x(50))


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_breaks_ties_lowest_index_first(router):
    """Integer-valued x and router give exact integer logits, so many rows
    tie; a zero router ties every expert of every row."""
    jcfg, tmoe = _cfgs(router_score=router, top_k=3, num_experts=6)
    rng = np.random.default_rng(4)
    x = rng.integers(-1, 2, (64, D)).astype(np.float32)
    w = rng.integers(0, 2, (D, 6)).astype(np.float32)
    jp, tp = _params(jcfg)
    for router_w in (w, np.zeros_like(w)):
        jp2 = dict(jp, router=jnp.asarray(router_w))
        tp2 = dict(tp, router=torch.from_numpy(router_w))
        ids = _check_route(jp2, tp2, jcfg, tmoe, x)
        logits = x @ router_w
        tied = [r for r in range(len(x)) if len(set(logits[r])) < 6]
        assert len(tied) > 10
    np.testing.assert_array_equal(ids, np.tile([0, 1, 2], (64, 1)))


def test_capacity_matches_reference():
    for T in (1, 7, 8, 64, 100, 128, 512, 2048):
        for E in (4, 16, 256):
            for k in (1, 2, 8):
                for cf in (1.0, 1.25, 4.0):
                    j = JMoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
                    t = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
                    assert moe.capacity(t, T) == jmoe.capacity(j, T)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_ff_matches_reference_without_drops(router, shared):
    jcfg, tmoe = _cfgs(router_score=router, num_shared=shared)
    jp, tp = _params(jcfg)
    x = _x(2 * 13).reshape(2, 13, D)
    jy, jaux = jmoe.moe_ff(jp, jcfg, jnp.asarray(x))
    tcfg = _port_model_cfg(jcfg, tmoe)
    tmoe_drops = torch.zeros((), dtype=torch.long)
    moe.moe_ff.drops = tmoe_drops
    try:
        ty, taux = moe.moe_ff(tp, tcfg, torch.from_numpy(x))
    finally:
        moe.moe_ff.drops = None
    assert int(tmoe_drops) == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _overflow_inputs():
    """32 tokens, E = 4, top-1, capacity factor 1 (C = 8): tokens 0–19 go to
    expert 0 and 20–31 to expert 2, both past their 8 slots."""
    jcfg, tmoe = _cfgs(num_shared=0, top_k=1, capacity_factor=1.0)
    jp, tp = _params(jcfg)
    router = np.zeros((D, 4), np.float32)
    router[0, 0] = router[1, 2] = 10.0
    x = _x(32) * 0.1
    x[:20, 0] = 1.0
    x[20:, 1] = 1.0
    return jcfg, tmoe, dict(jp, router=jnp.asarray(router)), dict(
        tp, router=torch.from_numpy(router)), x


def test_overflowing_expert_keeps_ranks_0_to_C_minus_1():
    """ROADMAP C, the capacity drops: the reference loses each overflowing
    expert's rank-0 token (tokens 0 and 20) and keeps ranks 1 … C−1; the
    port keeps ranks 0 … C−1. Everywhere else the outputs agree: ranks
    1 … 7 within the parity tolerance, the dropped ranks ≥ 8 zero in both."""
    jcfg, tmoe, jp, tp, x = _overflow_inputs()
    ids = np.asarray(jmoe._route(jp, jcfg.moe, jnp.asarray(x))[0])[:, 0]
    assert (ids[:20] == 0).all() and (ids[20:] == 2).all()
    assert moe.capacity(tmoe, 32) == 8
    jy = np.asarray(jmoe.moe_ff(jp, jcfg, jnp.asarray(x[None]))[0])[0]
    drops = torch.zeros((), dtype=torch.long)
    moe.moe_ff.drops = drops
    try:
        ty = moe.moe_ff(tp, _port_model_cfg(jcfg, tmoe), torch.from_numpy(x[None]))[0][0]
    finally:
        moe.moe_ff.drops = None
    ty = ty.numpy()
    assert int(drops) == (20 - 8) + (12 - 8)
    rank0 = [0, 20]
    assert (jy[rank0] == 0).all() and (np.abs(ty[rank0]).min(axis=1) > 0).all()
    kept = [t for t in range(32) if t not in rank0]
    np.testing.assert_allclose(ty[kept], jy[kept], rtol=1e-5, atol=1e-6)
    past_capacity = list(range(8, 20)) + list(range(28, 32))
    assert (ty[past_capacity] == 0).all() and (jy[past_capacity] == 0).all()
    assert (np.abs(ty[[1, 7, 21, 27]]).min(axis=1) > 0).all()


def test_combine_adds_k_outputs_in_order_and_repeats_bit_for_bit():
    """ROADMAP C, the combine: y = ((0 + y_s0·w0) + y_s1·w1) + y_s2·w2 per
    token, in top-k order — on outputs where another order of the three
    adds gives another float (1e8 + 1 − 1e8) — and a whole layer twice,
    bit-identical."""
    yg = torch.tensor([[1e8], [1.0], [-1e8], [0.0]])
    w = torch.ones((2, 3))
    pair_slot = torch.tensor([[0, 1, 2], [0, 2, 1]])
    y = moe._combine(yg, pair_slot, w)
    want = np.zeros((2, 1), np.float32)
    for j in range(3):
        want = want + yg.numpy()[pair_slot.numpy()[:, j]] * w.numpy()[:, j, None]
    assert want.tolist() == [[0.0], [1.0]]
    np.testing.assert_array_equal(y.numpy(), want)
    jcfg, tmoe = _cfgs(num_shared=0, top_k=3, num_experts=5)
    jp, tp = _params(jcfg)
    x = _x(24).reshape(2, 12, D)
    tcfg = _port_model_cfg(jcfg, tmoe)
    y1, _ = moe.moe_ff(tp, tcfg, torch.from_numpy(x))
    y2, _ = moe.moe_ff(tp, tcfg, torch.from_numpy(x))
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    jy, _ = jmoe.moe_ff(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
