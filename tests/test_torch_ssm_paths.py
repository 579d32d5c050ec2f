"""The recurrent families' model, serving and training paths against
``repro``, on the CPU: reduced recurrentgemma-2b (3 layers: RG-LRU, RG-LRU,
sliding-window attention; window 16) and xlstm-350m (8 layers: the whole
7 mLSTM : 1 sLSTM period — the reference's own ``tests/test_decode.py``
runs 2 layers, which keeps no sLSTM), d_model 64, with the reference's
parameters carried across by ``convert.params_from_jax``:

* ``forward`` logits at rtol 1e-5 with an atol of 1e-5 of their largest
  magnitude (ROADMAP C, the families' logits rule), ``lm_loss`` at rtol 1e-5, every
  leaf's gradient at rtol 1e-5 / atol 1e-6 for recurrentgemma; xLSTM's
  logits and gradients within ``XLSTM_SCALE`` of the largest magnitude
  (ROADMAP C, the xLSTM entry: against the port in float64 both packages'
  float32 logits sit 1.2e-5 / 1.7e-5 of that scale away at S = 40 and
  5.1e-5 / 7.1e-5 at S = 512, their gradients up to 3.9e-5 — 8 layers of
  stabilized exponentials and normalizer divisions,
  ``scripts/xlstm_precision.py``);
* decode from an empty state against the teacher-forced ``forward``, and
  prefill + decode against it, at the reference's ``tests/test_decode.py``
  tolerance (atol 5e-4, rtol 1e-3); the prefill state and each decode
  step's logits against the reference's within ``LOGIT_TOL`` = 1e-4;
* in float64 (parameters and recurrences), prefill + decode reproduce
  the forward to 1e-9: the float32 gaps are rounding, not the hand-off;
* the decode state is O(1): its leaves do not grow with ``max_len`` from
  64 to 4096 (recurrentgemma's rings stop at the window), with the
  reference's shapes;
* ``run_static`` gives the reference's greedy streams (left-padded
  prompts); ``run_continuous`` refuses a recurrent model with the
  reference's ``ValueError``;
* MARINA × block_randk: two rounds (a compressed one, then a sync one) of
  recompute rounds on recurrentgemma and carry rounds on xLSTM (the card's
  training leg) from the reference's state, under the same keys and
  batches: c_k and bits equal, params and g within 1e-4 of each leaf's
  scale (ROADMAP C, the LM entry) — xLSTM's within ``XLSTM_ROUND_SCALE``:
  the compressed round scales the gradients' float noise by B/kb = 16;
* the mLSTM chunk rule at the model: S = 300 is refused by both, S = 512
  runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core.flat import make_engine as j_make_engine
from repro.data import HeterogeneousLMData as JData
from repro.data import worker_batches as j_worker_batches
from repro.launch import serve as jserve
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models import prefill as j_prefill
from repro.models import reduced as j_reduced
from repro_torch import prng
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import BlockRandK, Marina, make_engine
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.models import decode_step, forward, init_cache, lm_loss, prefill

LOGIT_TOL = 1e-4
#: the reference's tests/test_decode.py tolerance (decode against forward)
DECODE_ATOL, DECODE_RTOL = 5e-4, 1e-3
#: xLSTM's logits and gradients: atol as a fraction of the largest
#: magnitude (S ≤ 256; at S = 512, two chunks, ``XLSTM_SCALE_512``)
XLSTM_SCALE, XLSTM_SCALE_512 = 1e-4, 3e-4
#: xLSTM's MARINA rounds: a compressed round scales the gradients' noise
#: (≤ 3.9e-5 of a leaf's scale) by B/kb = 16: measured 4.5e-4 on the flat g
XLSTM_ROUND_SCALE = 1e-3
#: case → (architecture, reduced layers)
CASES = {"recurrentgemma-2b": ("recurrentgemma-2b", 3), "xlstm-350m": ("xlstm-350m", 8)}
_MODELS: dict = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _model(case):
    """(reference config, port config, reference params, port params)."""
    if case not in _MODELS:
        name, layers = CASES[case]
        jcfg = j_reduced(j_get_arch(name).model, layers=layers, d_model=64)
        jp = j_init_params(jax.random.PRNGKey(0), jcfg)
        _MODELS[case] = (jcfg, port_cfg(jcfg), jp, params_from_jax(_np_tree(jp), device="cpu"))
    return _MODELS[case]


def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_to_scale(a, b, frac, rtol=1e-5):
    b = np.asarray(b)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol, atol=frac * scale)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_reduced_configs_keep_every_mixer():
    kinds = {c: [l.mixer for s in _model(c)[1].segments for l in s.period] for c in CASES}
    assert kinds["recurrentgemma-2b"] == ["rglru", "rglru", "attn_local"]
    assert kinds["xlstm-350m"] == ["mlstm"] * 7 + ["slstm"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_grads_match_reference(case):
    jcfg, tcfg, jp, tp = _model(case)
    xlstm = case == "xlstm-350m"
    toks = _tokens(jcfg, 0, 2, 40)
    jlogits = jax.jit(lambda p, t: j_forward(p, jcfg, t)[0])(jp, jnp.asarray(toks))
    jl, jg = jax.jit(jax.value_and_grad(j_lm_loss), static_argnums=1)(jp, jcfg,
                                                                      jnp.asarray(toks))
    leaves, treedef = tree_flatten(tp)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    params = tree_unflatten(treedef, leaves)
    with torch.no_grad():
        tlogits = forward(params, tcfg, torch.from_numpy(toks))[0]
    _close_to_scale(tlogits, jlogits, XLSTM_SCALE if xlstm else 1e-5)
    tl = lm_loss(params, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        if xlstm:
            _close_to_scale(a, b, XLSTM_SCALE)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_and_prefill_match_forward_and_reference(case):
    """20 tokens (past recurrentgemma's window of 16): decode from
    ``init_cache`` token by token, and a prefill of 11 then decode, against
    the teacher-forced ``forward``; the prefill state and the decode logits
    against the reference's."""
    jcfg, tcfg, jp, tp = _model(case)
    B, S, P = 2, 20, 11
    toks = _tokens(jcfg, 1, B, S)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        full = forward(tp, tcfg, tt)[0].numpy()
        cache = init_cache(tcfg, B, S, device="cpu")
        for t in range(S):
            lg, cache = decode_step(tp, tcfg, cache, tt[:, t], t)
            np.testing.assert_allclose(lg.numpy(), full[:, t], atol=DECODE_ATOL,
                                       rtol=DECODE_RTOL, err_msg=f"{case} decode at {t}")
        last, cache = prefill(tp, tcfg, tt[:, :P], max_len=S)
    np.testing.assert_allclose(last.numpy(), full[:, P - 1], atol=DECODE_ATOL, rtol=DECODE_RTOL)
    jlast, jcache = jax.jit(lambda p, t: j_prefill(p, jcfg, t, max_len=S))(
        jp, jnp.asarray(toks[:, :P]))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=LOGIT_TOL, rtol=0)
    for a, b in zip(jax.tree.leaves(jcache), _leaves(cache)):
        assert a.shape == tuple(b.shape)
        _close_to_scale(b, a, 1e-5)
    jdec = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    for t in range(P, S):
        jlg, jcache = jdec(jp, jcache, jnp.asarray(toks[:, t]), t)
        with torch.inference_mode():
            lg, cache = decode_step(tp, tcfg, cache, tt[:, t], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t], atol=DECODE_ATOL, rtol=DECODE_RTOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"{case} prefill + decode at {t}")


def test_float64_xlstm_decode_reproduces_the_forward():
    """The prefill state hand-off is exact: with the parameters in float64
    (the recurrences then run in float64), prefill + decode reproduce the
    teacher-forced forward to 1e-9 of the row's largest logit, where float32
    leaves up to ~1e-4 (ROADMAP C, the xLSTM entry; chip_smoke.py makes
    this check at full width)."""
    _, tcfg, _, tp = _model("xlstm-350m")
    p64 = tree_map(lambda t: t.double(), tp)
    B, S, P = 2, 24, 19
    toks = torch.from_numpy(_tokens(tcfg, 7, B, S))
    with torch.inference_mode():
        full = forward(p64, tcfg, toks)[0]
        _, cache = prefill(p64, tcfg, toks[:, :P], max_len=S)
        assert all(t.dtype == torch.float64 for t in _leaves(cache))
        for t in range(P, S):
            lg, cache = decode_step(p64, tcfg, cache, toks[:, t], t)
            assert lg.dtype == torch.float64
            err = (lg - full[:, t]).abs().max() / full[:, t].abs().max()
            assert float(err) <= 1e-9, (t, float(err))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_state_is_o1(case):
    """The state's leaves have the reference's shapes and the same sizes at
    ``max_len`` 64 and 4096."""
    jcfg, tcfg = _model(case)[:2]
    sizes = {}
    for max_len in (64, 4096):
        tc = init_cache(tcfg, 1, max_len, device="meta")
        jc = jax.eval_shape(lambda: j_init_cache(jcfg, 1, max_len, jnp.float32))
        assert [a.shape for a in jax.tree.leaves(jc)] == [tuple(b.shape) for b in _leaves(tc)]
        sizes[max_len] = [b.numel() for b in _leaves(tc)]
    assert sizes[64] == sizes[4096]  # recurrentgemma's rings: min(window 16, max_len)


def _j_static_streams(jp, cfg, reqs, batch):
    """The reference's ``run_static`` loop, keeping each row's greedy tokens."""
    out = []
    dec = jax.jit(lambda c, t, pos: j_decode_step(jp, cfg, c, t, pos))
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        pmax = max(r.prompt_len for r in group)
        gmax = max(r.max_new for r in group)
        toks = np.zeros((len(group), pmax), np.int32)
        for j, r in enumerate(group):
            toks[j, pmax - r.prompt_len:] = r.prompt
        logits, cache = jax.jit(lambda t: j_prefill(jp, cfg, t, max_len=pmax + gmax))(
            jnp.asarray(toks))
        rows = [jnp.argmax(logits, -1)]
        for step in range(1, gmax):
            lg, cache = dec(cache, rows[-1], pmax + step - 1)
            rows.append(jnp.argmax(lg, -1))
        arr = np.stack([np.asarray(t) for t in rows], axis=1)
        out += [arr[j, :r.max_new].tolist() for j, r in enumerate(group)]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_static_streams_match_reference_and_continuous_refuses(case):
    jcfg, tcfg, jp, tp = _model(case)
    pairs = [(22, 5), (9, 7)]
    treqs = tserve.make_workload(tcfg, pairs)
    rep = tserve.run_static(tp, tcfg, treqs, batch=2)
    assert rep["total_new_tokens"] == sum(g for _, g in pairs)
    assert [r.generated for r in treqs] == _j_static_streams(
        jp, jcfg, jserve.make_workload(jcfg, pairs), 2)
    for pkg, params, cfg in ((jserve, jp, jcfg), (tserve, tp, tcfg)):
        with pytest.raises(ValueError, match="global-attention mixers only"):
            pkg.run_continuous(params, cfg, pkg.make_workload(cfg, pairs), slots=2,
                               page_size=4)


@pytest.mark.parametrize("case,carry", [("recurrentgemma-2b", False), ("xlstm-350m", True)],
                         ids=["recurrentgemma-recompute", "xlstm-carry"])
def test_marina_rounds_match_reference(case, carry):
    """The reference's init on step 0's batches, its state carried across,
    then two rounds of both packages under the same keys and batches (the
    keys fold_in(PRNGKey(1), k): a compressed round, then a sync round): c_k
    and bits equal, params and g within 1e-4 of each leaf's scale."""
    jcfg, tcfg, jp, tp = _model(case)
    data = JData(n_workers=2, vocab_size=jcfg.vocab_size, seq_len=16, seed=3)
    batches = [np.asarray(j_worker_batches(data, s, 2)) for s in range(3)]

    def tgrad(p, b):
        leaves, treedef = tree_flatten(p)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        loss = lm_loss(tree_unflatten(treedef, leaves), tcfg, b["tokens"])
        return tree_unflatten(treedef, torch.autograd.grad(loss, leaves))

    jgrad = jax.grad(lambda p, b: j_lm_loss(p, jcfg, b["tokens"]))
    jeng = j_make_engine(jp, block=128, backend="ref", sampler="randk", kb=8)
    teng = make_engine(tp, block=128, device="cpu", sampler="randk", kb=8)
    jm = JMarina(jgrad, JBlockRandK(kb=8, block=128), gamma=0.05, p=0.4, engine=jeng,
                 carry=carry)
    tm = Marina(tgrad, BlockRandK(kb=8, block=128), gamma=0.05, p=0.4, engine=teng,
                carry=carry)
    js = jax.jit(jm.init)(jp, {"tokens": jnp.asarray(batches[0])})
    ts = state_from_jax(_np_tree(js.params), _np_tree(js.g), 0,
                        None if js.h is None else _np_tree(js.h), device="cpu")
    jstep = jax.jit(jm.step)
    kinds = []
    for k in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(1), k)
        js, jmet = jstep(js, key, {"tokens": jnp.asarray(batches[k + 1])})
        ts, tmet = tm.step(ts, prng.fold_in(prng.PRNGKey(1), k),
                           {"tokens": torch.tensor(batches[k + 1])})
        assert tmet.sync_round == int(jmet.sync_round)
        assert tmet.bits_per_worker == float(jmet.bits_per_worker)
        kinds.append(tmet.sync_round)
        for tree_t, tree_j in ((ts.params, js.params), (ts.g, js.g)):
            for a, b in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                _close_to_scale(a, b, XLSTM_ROUND_SCALE if case == "xlstm-350m" else 1e-4)
    assert kinds == [0, 1]


def test_mlstm_chunk_rule_at_the_model():
    """S = 300 is neither ≤ 256 nor a multiple of 256: the reference asserts,
    the port raises ``ValueError``; S = 512 (two chunks) runs in both, the
    logits within ``XLSTM_SCALE_512`` of the largest (6.7e-5 in
    ``scripts/xlstm_precision.py``)."""
    jcfg, tcfg, jp, tp = _model("xlstm-350m")
    bad = _tokens(jcfg, 5, 1, 300)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda p, t: j_forward(p, jcfg, t)[0], jp, bad)
    with pytest.raises(ValueError, match="multiple of the chunk"), torch.inference_mode():
        forward(tp, tcfg, torch.from_numpy(bad))
    good = _tokens(jcfg, 6, 1, 512)
    jl = jax.jit(lambda p, t: j_forward(p, jcfg, t)[0])(jp, jnp.asarray(good))
    with torch.inference_mode():
        tl = forward(tp, tcfg, torch.from_numpy(good))[0]
    _close_to_scale(tl, jl, XLSTM_SCALE_512)
