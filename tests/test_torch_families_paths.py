"""The attention and MoE families' serving and training paths against
``repro``, on the CPU, on ``tests/test_torch_families.py``'s reduced
configs (the reference's parameters carried across):

* ``paged_prefill_chunk`` then ``paged_decode_step`` for the
  global-attention configs (llama4-scout with MoE, musicgen with sinusoidal
  positions, qwen3, deepseek-coder, internvl2): each step's logits within
  ``LOGIT_TOL`` of the reference's with ``backend="ref"`` (whose cache
  advances) and with the Pallas kernel in interpret mode.
* ``launch.serve.run_static`` serves the sliding-window and MLA configs
  with the reference's greedy streams; ``run_continuous`` refuses them
  with the reference's error.
* Two MARINA × block_randk rounds (both round shapes) on reduced
  llama4-scout and deepseek-v3 with the reference's token batches: c_k and
  bits equal, params and g leafwise within 1e-4 of each leaf's scale (the
  routers' leaves within 5e-4: ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core import BlockRandK as JBlockRandK
from repro.core import Marina as JMarina
from repro.core.flat import make_engine as j_make_engine
from repro.data import HeterogeneousLMData as JData
from repro.data import worker_batches as j_worker_batches
from repro.launch import serve as jserve
from repro.models import decode_step as j_decode_step
from repro.models import init_paged_cache as j_init_paged_cache
from repro.models import lm_loss as j_lm_loss
from repro.models import paged_decode_step as j_paged_decode_step
from repro.models import paged_prefill_chunk as j_paged_prefill_chunk
from repro.models import prefill as j_prefill
from repro_torch import prng
from repro_torch.convert import state_from_jax
from repro_torch.core import BlockRandK, Marina, make_engine
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.models import lm_loss, paged_decode_step, paged_prefill_chunk
from test_torch_families import LOGIT_TOL, _close_to_leaf_scale, _model, _np_tree, _to_port

#: the configs the paged serving engine takes (global attention only)
PAGED = ("llama4-scout-17b-a16e", "musicgen-medium", "qwen3-32b", "deepseek-coder-33b",
         "internvl2-1b")


@pytest.mark.parametrize("case", PAGED)
def test_paged_steps_match_reference(case):
    """Chunked prefill of two prompts (chunks of 4, pages of 4), then three
    batched decode steps with an idle slot; the port's pool is its own."""
    _, jcfg, tcfg, jp, tp = _model(case)
    rng = np.random.default_rng(2)
    P, maxp, C, S = 4, 6, 4, 3
    npage = 1 + S * maxp
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in (7, 11)]
    jcache = j_init_paged_cache(jcfg, npage, P)
    tcache = _to_port(jcache)
    tables = np.zeros((S, maxp), np.int32)
    lengths = np.zeros((S,), np.int32)
    toks = np.zeros((S,), np.int32)
    pages = iter(range(1, npage))
    for s, prompt in enumerate(prompts):
        tables[s] = [next(pages) for _ in range(maxp)]
        for start in range(0, len(prompt), C):
            nv = len(prompt[start:start + C])
            piece = np.pad(prompt[start:start + C], (0, C - nv))[None]
            jl, jcache = j_paged_prefill_chunk(jp, jcfg, jcache, jnp.asarray(piece),
                                               jnp.int32(start), jnp.asarray(tables[s]),
                                               jnp.int32(nv), backend="ref")
            with torch.inference_mode():
                tl, tcache = paged_prefill_chunk(tp, tcfg, tcache, torch.from_numpy(piece),
                                                 start, torch.from_numpy(tables[s]), nv)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
        lengths[s], toks[s] = len(prompt), int(jnp.argmax(jl))
    for step in range(3):  # slot 2 idles: length 0, null table row
        args = [toks, lengths, np.where(lengths[:, None] > 0, tables, 0)]
        jargs = [jnp.asarray(a) for a in args]
        jl_int, _ = j_paged_decode_step(jp, jcfg, jcache, *jargs,
                                        backend="pallas_interpret")
        jl, jcache = j_paged_decode_step(jp, jcfg, jcache, *jargs, backend="ref")
        with torch.inference_mode():
            tl, tcache = paged_decode_step(tp, tcfg, tcache,
                                           *(torch.from_numpy(a.copy()) for a in args))
        for s in range(len(prompts)):
            for want in (jl, jl_int):
                np.testing.assert_allclose(tl[s].numpy(), np.asarray(want[s]),
                                           atol=LOGIT_TOL, rtol=0,
                                           err_msg=f"{case} step {step} slot {s}")
        toks = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert np.array_equal(torch.argmax(tl[:2], -1).numpy(), toks[:2])
        lengths[:len(prompts)] += 1


def _j_static_streams(jp, cfg, reqs, batch):
    """The reference's ``run_static`` loop, keeping each row's greedy tokens
    (the reference times them and drops them)."""
    out = []
    dec = jax.jit(lambda c, t, pos: j_decode_step(jp, cfg, c, t, pos))
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        pmax = max(r.prompt_len for r in group)
        gmax = max(r.max_new for r in group)
        toks = np.zeros((len(group), pmax), np.int32)
        for j, r in enumerate(group):
            toks[j, pmax - r.prompt_len:] = r.prompt
        logits, cache = j_prefill(jp, cfg, jnp.asarray(toks), max_len=pmax + gmax)
        rows = [jnp.argmax(logits, -1)]
        for step in range(1, gmax):
            lg, cache = dec(cache, rows[-1], pmax + step - 1)
            rows.append(jnp.argmax(lg, -1))
        arr = np.stack([np.asarray(t) for t in rows], axis=1)
        out += [arr[j, :r.max_new].tolist() for j, r in enumerate(group)]
    return out


@pytest.mark.parametrize("case", ["gemma3-27b-6l", "deepseek-v3-671b"])
def test_serve_static_streams_and_continuous_refusal(case):
    """Prompts of 9 to 22 tokens (rings wrap at 16) in batches of 2: the
    port's ``run_static`` gives the reference's greedy streams; the paged
    engine refuses a sliding-window or MLA model as the reference does."""
    _, jcfg, tcfg, jp, tp = _model(case)
    pairs = [(22, 5), (9, 7), (17, 4)]
    treqs = tserve.make_workload(tcfg, pairs)
    rep = tserve.run_static(tp, tcfg, treqs, batch=2)
    assert rep["total_new_tokens"] == sum(g for _, g in pairs)
    assert [r.generated for r in treqs] == _j_static_streams(
        jp, jcfg, jserve.make_workload(jcfg, pairs), 2)
    for pkg, params, cfg in ((jserve, jp, jcfg), (tserve, tp, tcfg)):
        with pytest.raises(ValueError, match="global-attention mixers only"):
            pkg.run_continuous(params, cfg, pkg.make_workload(cfg, pairs), slots=2,
                               page_size=4)


#: the MoE routers' leaves: their gradient carries 1e-5 to 3e-5 of its scale
#: of float noise in either package (against float64: the port 1.0e-5, the
#: reference 2.4e-5), from the cancellations of the top-k-normalized softmax,
#: which a compressed round amplifies (×B/kb = 16) to 1.4e-4 (ROADMAP C)
ROUTER_RTOL = 5e-4


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("case", ["llama4-scout-17b-a16e", "deepseek-v3-671b"])
def test_marina_rounds_match_reference(case, carry):
    """The reference's init on step 0's batches, its state carried across,
    then two rounds of both packages under the same keys and batches: c_k
    and bits equal, params and g within 1e-4 of each leaf's scale (a router's
    within ``ROUTER_RTOL``). The keys
    fold_in(PRNGKey(1), k) give a compressed round, then a sync round."""
    _, jcfg, tcfg, jp, tp = _model(case)
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
            flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
            for a, (path, b) in zip(tree_leaves(tree_t), flat_j):
                _close_to_leaf_scale(a, b, ROUTER_RTOL if "router" in
                                     jax.tree_util.keystr(path) else 1e-4)
    assert kinds == [0, 1]
