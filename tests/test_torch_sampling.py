"""Sampling at a temperature: the port's ``prng`` draws and the serving
paths against ``jax.random`` and ``repro.launch.serve``, on the CPU.

* ``prng.uniform(key, shape, minval, maxval)`` is bit-equal to
  ``jax.random.uniform`` — at ``minval`` = float32 tiny (the Gumbel draw's
  range) and at other ranges, where XLA fuses (f − 1)·(max − min) + min
  into one rounding — on the host and on a device (``device="cpu"``).
* ``prng.gumbel`` takes the two logarithms in float64 and rounds once:
  within ``GUMBEL_ULPS`` units of ulp(max(|g|, 1)) of ``jax.random.gumbel``
  (XLA's float32 ``log`` is an approximation; ROADMAP C), and the device
  draw equals the host's bit for bit.
* ``prng.categorical`` against ``jax.random.categorical`` on random logits
  at three temperatures: equal tokens except where JAX's two largest
  perturbed logits lie within ``CATEGORICAL_TIE`` (each perturbed logit can
  move by the Gumbel bound); the near ties are counted.
* ``launch.serve.run_static`` (reduced recurrentgemma-2b: RG-LRU and a
  sliding-window layer) and ``run_continuous`` (the reduced GQA config of
  ``tests/test_torch_serve.py``) at T = 0.7 under seeds 0 and 5, against
  the reference's loops with its key threading (static: a split per
  batch's prefill and per decode step, logits / T an eager division; paged:
  a split per prefill chunk and per decode step, logits × f32(1/T), as XLA
  computes the division under ``jit``): each request's stream equal to the
  reference's up to a token where the reference's two largest perturbed
  logits lie within ``SERVE_TIE`` (the model's logits differ by up to
  ``LOGIT_TOL`` = 1e-4, ÷ T), after which that request is not compared.
  The instrumented reference steps are held to the reference's own engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.launch import serve as jserve
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import paged_decode_step as j_paged_decode_step
from repro.models import paged_prefill_chunk as j_paged_prefill_chunk
from repro.models import prefill as j_prefill
from repro.models import reduced as j_reduced
from repro_torch import prng
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve

TINY = float(np.finfo(np.float32).tiny)
#: prng.gumbel against jax.random.gumbel: units of ulp(max(|g|, 1))
GUMBEL_ULPS = 2
#: the perturbed logits' top-2 gap below which a different token is a tie
#: (twice the Gumbel bound at |g| < 32: 2 · 2 · 2^-19)
CATEGORICAL_TIE = 8e-6
TEMPERATURE = 0.7
LOGIT_TOL = 1e-4
#: a serve path's tie gap: twice the logits' tolerance over T plus the
#: Gumbel bound
SERVE_TIE = 2 * (LOGIT_TOL / TEMPERATURE) + CATEGORICAL_TIE


def _unit(x):
    return np.spacing(np.maximum(np.abs(x), np.float32(1)).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("lo,hi", [(TINY, 1.0), (0.0, 1.0), (-2.0, 3.0), (0.7, 5.0),
                                   (-1e-3, 1e4), (1e-30, 3e-30)])
def test_uniform_bits_equal_jax(lo, hi):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, (4099,), minval=lo, maxval=hi))
        host = prng.uniform(np.asarray(key), (4099,), lo, hi)
        dev = prng.uniform(np.asarray(key), (4099,), lo, hi, device="cpu").numpy()
        assert host.dtype == np.float32 and dev.dtype == np.float32
        assert np.array_equal(host.view(np.int32), want.view(np.int32))
        assert np.array_equal(dev.view(np.int32), want.view(np.int32))
        assert float(host.min()) >= np.float32(lo)


@pytest.mark.parametrize("shape", [(), (7,), (3, 1000), (2, 3, 5000)])
def test_gumbel_within_its_bound_of_jax(shape):
    worst = 0.0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(key, shape), np.float64)
        host = prng.gumbel(np.asarray(key), shape)
        dev = prng.gumbel(np.asarray(key), shape, device="cpu").numpy()
        assert host.shape == shape and host.dtype == np.float32
        assert np.array_equal(dev.view(np.int32), host.view(np.int32))
        worst = max(worst, float(np.max(np.abs(host - want) / _unit(host), initial=0.0)))
    assert worst <= GUMBEL_ULPS, worst


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
def test_categorical_matches_jax_except_near_ties(temperature):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((8, 1000)) * 3).astype(np.float32)
    scaled = logits / np.float32(temperature)
    ties = []
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(scaled)))
        got = prng.categorical(np.asarray(key), torch.from_numpy(scaled)).numpy()
        assert np.array_equal(prng.categorical(np.asarray(key), scaled), got)
        z = np.sort(np.asarray(jax.random.gumbel(key, scaled.shape)) + scaled, axis=-1)
        gap = z[:, -1] - z[:, -2]
        for b in np.flatnonzero(got != want):
            assert gap[b] < CATEGORICAL_TIE, (seed, b, gap[b])
            ties.append((seed, int(b), float(gap[b])))
    assert len(ties) <= 2, ties  # near ties are rare: listed when they occur


def _draw(logits_scaled, key):
    """The reference's draw, keeping the perturbed logits' top-2 gap."""
    z = jax.random.gumbel(key, logits_scaled.shape) + logits_scaled
    top = jnp.sort(z, axis=-1)
    return np.asarray(jnp.argmax(z, axis=-1)), np.asarray(top[..., -1] - top[..., -2])


def _compare_streams(got, want, gaps):
    """Equal up to a reference near tie (then that request stops being
    compared); returns the near ties taken."""
    ties = []
    for rid, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b)
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            assert gaps[rid][j] < SERVE_TIE, (rid, j, gaps[rid][j])
            ties.append((rid, j, gaps[rid][j]))
    return ties


def _j_static_sampled(jp, cfg, reqs, batch, seed):
    """The reference's ``run_static`` loop at TEMPERATURE, keeping each row's
    tokens and, per token, its perturbed logits' top-2 gap."""
    key = jax.random.PRNGKey(seed)
    dec = jax.jit(lambda c, t, pos: j_decode_step(jp, cfg, c, t, pos))
    streams, gaps = [], []
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        pmax = max(r.prompt_len for r in group)
        gmax = max(r.max_new for r in group)
        toks = np.zeros((len(group), pmax), np.int32)
        for j, r in enumerate(group):
            toks[j, pmax - r.prompt_len:] = r.prompt
        logits, cache = jax.jit(lambda t: j_prefill(jp, cfg, t, max_len=pmax + gmax))(
            jnp.asarray(toks))
        key, sub = jax.random.split(key)
        tok, gap = _draw(logits / TEMPERATURE, sub)
        rows, grow = [tok], [gap]
        for step in range(1, gmax):
            lg, cache = dec(cache, jnp.asarray(tok, jnp.int32), pmax + step - 1)
            key, sub = jax.random.split(key)
            tok, gap = _draw(lg / TEMPERATURE, sub)
            rows.append(tok)
            grow.append(gap)
        arr, garr = np.stack(rows, axis=1), np.stack(grow, axis=1)
        streams += [arr[j, :r.max_new].tolist() for j, r in enumerate(group)]
        gaps += [garr[j, :r.max_new].tolist() for j, r in enumerate(group)]
    return streams, gaps


@pytest.fixture(scope="module")
def recurrent():
    jcfg = j_reduced(j_get_arch("recurrentgemma-2b").model, layers=3, d_model=64)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                                     device="cpu")


@pytest.mark.parametrize("seed", [0, 5])
def test_run_static_samples_match_reference(recurrent, seed):
    """Three requests in batches of 2 (left-padded; prompts past the
    window of 16), 6 to 9 tokens each; the same seed gives the same
    streams twice."""
    jcfg, tcfg, jp, tp = recurrent
    pairs = [(22, 9), (9, 6), (17, 8)]
    treqs = tserve.make_workload(tcfg, pairs)
    tserve.run_static(tp, tcfg, treqs, batch=2, temperature=TEMPERATURE, seed=seed)
    want, gaps = _j_static_sampled(jp, jcfg, jserve.make_workload(jcfg, pairs), 2, seed)
    got = [r.generated for r in treqs]
    _compare_streams(got, want, gaps)
    again = tserve.make_workload(tcfg, pairs)
    tserve.run_static(tp, tcfg, again, batch=2, temperature=TEMPERATURE, seed=seed)
    assert [r.generated for r in again] == got
    greedy = tserve.make_workload(tcfg, pairs)
    tserve.run_static(tp, tcfg, greedy, batch=2)
    assert [r.generated for r in greedy] != got  # T = 0.7 does sample


#: the reduced GQA config of tests/test_torch_serve.py
GQA = dataclasses.replace(j_reduced(j_get_arch("qwen3-32b").model, layers=2, d_model=128),
                          num_kv_heads=2)


@pytest.fixture(scope="module")
def gqa():
    jp = j_init_params(jax.random.PRNGKey(0), GQA)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _j_paged_steps_with_gaps(jp, cfg, seed, gaps_out):
    """The reference's paged steps at TEMPERATURE with its key threading,
    the draw taken apart: each step appends (kind, top-2 gaps) to
    ``gaps_out`` (per slot for a decode step)."""
    steps = jserve.build_paged_steps(jp, cfg)
    state = {"key": jax.random.PRNGKey(seed)}
    prefill = jax.jit(lambda c, t, s, r, n: j_paged_prefill_chunk(jp, cfg, c, t, s, r, n))
    decode = jax.jit(lambda c, t, ln, tb: j_paged_decode_step(jp, cfg, c, t, ln, tb))
    scale = jax.jit(lambda lg: lg / TEMPERATURE)  # XLA: a multiply by f32(1/T)

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def prefill_fn(cache, toks, start, row, nv):
        lg, cache = prefill(cache, toks, start, row, nv)
        tok, gap = _draw(scale(lg), next_key())
        gaps_out.append(("prefill", gap))
        return tok.astype(np.int32), cache

    def decode_fn(cache, toks, lengths, tables):
        lg, cache = decode(cache, toks, lengths, tables)
        tok, gap = _draw(scale(lg), next_key())
        gaps_out.append(("decode", gap))
        return tok.astype(np.int32), cache

    return dict(steps, prefill=prefill_fn, decode=decode_fn)


@pytest.mark.parametrize("seed", [0, 5])
def test_paged_engine_samples_match_reference(gqa, seed):
    jp, tp = gqa
    tcfg = port_cfg(GQA)
    pairs = [(9, 6), (3, 4), (14, 5), (6, 7), (2, 3)]
    kw = dict(slots=3, page_size=4, chunk=4)
    # the reference's own engine, and the same steps taken apart
    jreqs = jserve.make_workload(GQA, pairs)
    jserve.run_continuous(jp, GQA, jreqs, steps=jserve.build_paged_steps(
        jp, GQA, temperature=TEMPERATURE, seed=seed), **kw)
    log: list = []
    ireqs = jserve.make_workload(GQA, pairs)
    engine_gaps = _instrumented_run(jp, ireqs, seed, log, kw)
    assert [r.generated for r in ireqs] == [r.generated for r in jreqs]
    treqs = tserve.make_workload(tcfg, pairs)
    tserve.run_continuous(tp, tcfg, treqs, temperature=TEMPERATURE, seed=seed, **kw)
    got = [r.generated for r in treqs]
    _compare_streams(got, [r.generated for r in jreqs], engine_gaps)
    again = tserve.make_workload(tcfg, pairs)
    tserve.run_continuous(tp, tcfg, again, temperature=TEMPERATURE, seed=seed, **kw)
    assert [r.generated for r in again] == got


def _instrumented_run(jp, reqs, seed, log, kw):
    """Run the reference's engine over the taken-apart steps, recording for
    each request the top-2 gap of the draw behind each of its tokens: a
    prefill chunk's draw is its request's first token when the chunk ends
    the prompt; a decode step's row s belongs to the request in slot s."""
    from repro.core.paging import PagedLayout
    from repro.launch.scheduler import ContinuousEngine, ContinuousScheduler
    from repro.models import init_paged_cache

    steps = _j_paged_steps_with_gaps(jp, GQA, seed, log)
    need = max(r.prompt_len + r.max_new for r in reqs)
    max_pages = -(-need // kw["page_size"])
    layout = PagedLayout(npage=1 + kw["slots"] * max_pages, page_size=kw["page_size"],
                         max_pages=max_pages, n_slots=kw["slots"])
    sched = ContinuousScheduler(layout)
    eng = ContinuousEngine(sched, init_paged_cache(GQA, layout.npage, layout.page_size),
                           steps["prefill"], steps["decode"], chunk=kw["chunk"],
                           copy_fn=steps["copy"], gather_fn=steps["gather"],
                           scatter_fn=steps["scatter"])
    gaps = {r.rid: [] for r in reqs}
    prefill_fn, decode_fn = eng.prefill_fn, eng.decode_fn

    def prefill_logged(cache, toks, start, row, nv):
        req = min((r for r in sched.active if r.prefilling), key=lambda r: r.t_admit)
        out = prefill_fn(cache, toks, start, row, nv)
        if req.prefill_done + int(nv) == req.prompt_len:
            gaps[req.rid].append(float(log[-1][1]))
        return out

    def decode_logged(cache, toks, lengths, tables):
        slots = list(sched.slots)
        out = decode_fn(cache, toks, lengths, tables)
        for s, req in enumerate(slots):
            if req is not None and req.decoding and lengths[s] > 0:
                gaps[req.rid].append(float(log[-1][1][s]))
        return out

    eng.prefill_fn, eng.decode_fn = prefill_logged, decode_logged
    eng.run(reqs)
    return [gaps[r.rid] for r in reqs]


def test_serve_cli_samples_recurrentgemma_statically(capsys):
    """The reference's usage example (``--arch recurrentgemma-2b --mode
    static``) at a temperature and a seed, on the CPU."""
    tserve.main(["--arch", "recurrentgemma-2b", "--device", "cpu", "--mode", "static",
                 "--batch", "2", "--prompt", "12", "--gen", "4", "--temperature", "0.7",
                 "--seed", "3"])
    out = capsys.readouterr().out
    assert '"n_requests": 2' in out and '"total_new_tokens": 8' in out
