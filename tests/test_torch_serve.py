"""The port's paged serving path against ``repro``'s, on the CPU:

* ``models.config.reduced`` equals the reference's for every architecture;
* the plain versions of the int8 KV-row kernels (``absmax_quant_rows``,
  ``absmax_dequant_rows``) are bit-equal to ``repro.kernels.ref`` and to the
  Pallas kernels in interpret mode, and f32(1/127) has numpy's bits in the
  plain version and in the CUDA source;
* the paged-attention plain version (and the int8 route) agree with the
  reference's oracle and its interpret-mode kernel within rtol 1e-5 (torch
  and XLA sum the einsums in other orders);
* on a reduced GQA config (Qwen3-32B's family, 2 layers, d_model 128, H = 4,
  KV = 2, qk-norm): the dense ``prefill`` / ``decode_step`` and the paged
  ``paged_prefill_chunk`` / ``paged_decode_step`` give logits within the
  reference's ``LOGIT_TOL`` = 1e-4, teacher-forced one step at a time from
  the JAX cache carried across by ``params_from_jax`` (int8 pages: softmaxes
  within atol 5e-3, as tests/test_serve.py holds them); the page copy,
  gather and scatter are exact;
* ``run_continuous`` (f32 and int8 pages, prefix sharing with COW, an
  undersized pool that preempts) and ``run_static`` give the reference's
  greedy token streams and ``ServeReport`` counters.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg, to_np  # noqa: F401
from repro.configs import PUBLIC_TO_MODULE as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.kernels import paged as jpaged
from repro.kernels import quantize as jquant
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import decode_step as j_decode_step
from repro.models import init_paged_cache as j_init_paged_cache
from repro.models import init_params as j_init_params
from repro.models import paged_copy_pages as j_copy
from repro.models import paged_decode_step as j_paged_decode_step
from repro.models import paged_gather_pages as j_gather
from repro.models import paged_prefill_chunk as j_paged_prefill_chunk
from repro.models import paged_scatter_pages as j_scatter
from repro.models import prefill as j_prefill
from repro.models import reduced as j_reduced
from repro_torch import kernels
from repro_torch.convert import params_from_jax
from repro_torch.kernels import paged as tpaged
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import (
    LayerSpec,
    Segment,
    decode_step,
    forward,
    init_paged_cache,
    paged_copy_pages,
    paged_decode_step,
    paged_gather_pages,
    paged_prefill_chunk,
    paged_scatter_pages,
    prefill,
    reduced,
)

LOGIT_TOL = 1e-4
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro_torch", "kernels",
                    "csrc")


#: the reduced GQA config: Qwen3-32B's family (qk-norm, head_dim set) at 2
#: layers, d_model 128, with 2 kv heads for 4 query heads
JCFG = dataclasses.replace(j_reduced(j_get_arch("qwen3-32b").model, layers=2, d_model=128),
                           num_kv_heads=2)
TCFG = port_cfg(JCFG)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return params_from_jax(_np_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jax.random.PRNGKey(0), JCFG)
    return jp, _to_port(jp)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_reduced_matches_reference(name):
    j = j_get_arch(name).model
    want = dataclasses.asdict(j_reduced(j, layers=2, d_model=128))
    assert dataclasses.asdict(reduced(port_cfg(j), layers=2, d_model=128)) == want
    assert dataclasses.asdict(reduced(port_cfg(j))) == dataclasses.asdict(j_reduced(j))


def test_reduced_gqa_config_shape():
    assert (TCFG.num_heads, TCFG.num_kv_heads, TCFG.resolved_head_dim) == (4, 2, 32)
    assert TCFG.qk_norm and TCFG.num_layers == 2


# ---------------------------------------------------------------------------
# the int8 KV rows: plain versions bit-equal to the reference and Pallas
# ---------------------------------------------------------------------------


def _edge_rows(W: int) -> np.ndarray:
    """A zero row, exact .5 ties (127·k/2 for scale 1), ±0 and ±127·scale."""
    rows = np.zeros((6, W), np.float32)
    rows[1, :] = np.float32(127.0)            # amax 127 → scale f32(127·f32(1/127))
    rows[1, ::2] = np.arange(W // 2, dtype=np.float32) % 127 + 0.5
    rows[2, :W // 2] = -0.0
    rows[2, W // 2:] = 0.0
    rows[3] = np.linspace(-254.0, 254.0, W, dtype=np.float32)  # ±127·scale, scale 2
    rows[3, 0], rows[3, -1] = -254.0, 254.0
    rows[4] = np.float32(2.5) * np.sign(np.arange(W) % 3 - 1)
    rows[4, 0] = 317.5                          # ties at x/safe = k + 0.5
    rows[5] = np.float32(1e-30) * (np.arange(W) - W / 2)
    return rows


def _absmax_inputs():
    rng = np.random.default_rng(2)
    out = [("edge64", _edge_rows(64)), ("edge128", _edge_rows(128))]
    for R, W in ((6, 8), (37, 64), (19, 128)):
        out.append((f"normal{R}x{W}", rng.normal(size=(R, W)).astype(np.float32) * 3))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,x", _absmax_inputs(), ids=[l for l, _ in _absmax_inputs()])
def test_absmax_rows_plain_bit_equal_to_reference_and_pallas(label, x, dtype):
    jx = jnp.asarray(x).astype(dtype)
    tx = params_from_jax(np.asarray(jx), device="cpu")
    kernels.reset_launch_counts()
    c_t, s_t = tquant.absmax_quant_rows(tx)
    for c_j, s_j in (jref.absmax_quant_rows_ref(jx),
                     jquant.absmax_quant_rows(jx, backend="pallas_interpret")):
        np.testing.assert_array_equal(to_np(c_t), np.asarray(c_j))
        np.testing.assert_array_equal(to_np(s_t).view(np.uint32),
                                      np.asarray(s_j).view(np.uint32))
    d_t = tquant.absmax_dequant_rows(c_t, s_t)
    assert not any(kernels.launch_counts().values()), "a CPU tensor launched a kernel"
    for d_j in (jref.absmax_dequant_rows_ref(c_j, s_j),
                jquant.absmax_dequant_rows(c_j, s_j, backend="pallas_interpret")):
        np.testing.assert_array_equal(to_np(d_t).view(np.uint32),
                                      np.asarray(d_j).view(np.uint32))


def test_absmax_constant_has_numpys_bits():
    """f32(1/127) is the double 1/127 rounded to float: the plain version's
    constant and the CUDA source's literal both carry that bit pattern."""
    bits = int(np.float32(1.0 / 127.0).view(np.uint32))
    assert bits == 0x3C010204
    assert int(np.float32(tref.ABSMAX_INV127).view(np.uint32)) == bits
    with open(os.path.join(CSRC, "quantize.cu")) as f:
        src = f.read()
    assert f"#define ABSMAX_INV127_BITS 0x{bits:08X}u" in src
    assert "__uint_as_float(ABSMAX_INV127_BITS)" in src


# ---------------------------------------------------------------------------
# paged attention: plain version vs the reference's oracle and kernel
# ---------------------------------------------------------------------------


def _paged_inputs(seed, S, H, KV, hd, P, maxp, npage):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    kp = rng.normal(size=(npage, P, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(npage, P, KV, hd)).astype(np.float32)
    tables = np.zeros((S, maxp), np.int32)
    n_valid = np.zeros((S,), np.int32)
    perm = rng.permutation(np.arange(1, npage)).astype(np.int32)
    for s in range(S):
        n_valid[s] = rng.integers(1, maxp * P + 1) if s else maxp * P
        used = -(-n_valid[s] // P)
        tables[s, :used] = perm[s * maxp:s * maxp + used]
    return q, kp, vp, tables, n_valid


PAGED_SHAPES = [(3, 4, 2, 8, 4, 3, 10), (4, 8, 2, 32, 4, 5, 21), (2, 4, 4, 64, 8, 3, 7)]


@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=str)
def test_paged_attn_plain_matches_reference_and_pallas(shape):
    q, kp, vp, tables, n_valid = _paged_inputs(0, *shape)
    kernels.reset_launch_counts()
    got = tpaged.paged_attn_decode(*(torch.from_numpy(a) for a in (q, kp, vp, tables,
                                                                   n_valid)))
    assert not any(kernels.launch_counts().values()), "a CPU tensor launched a kernel"
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, n_valid)]
    for backend in ("ref", "pallas_interpret"):
        want = np.asarray(jpaged.paged_attn_decode(*args, backend=backend))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_paged_attn_plain_bf16_matches_reference_oracle():
    q, kp, vp, tables, n_valid = _paged_inputs(1, *PAGED_SHAPES[1])
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    want = jref.paged_attn_decode_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(n_valid))
    tq, tk, tv = (params_from_jax(np.asarray(a), device="cpu") for a in (jq, jk, jv))
    got = tpaged.paged_attn_decode(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(n_valid))
    assert got.dtype == torch.bfloat16
    # bf16 logits, weights and outputs: one bf16 rounding (2^-8) of v's scale
    vmax = float(np.abs(np.asarray(jv, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=2**-8 * vmax)


@pytest.mark.parametrize("shape", PAGED_SHAPES[:2], ids=str)
def test_paged_attn_q8_route_matches_reference(shape):
    q, kp, vp, tables, n_valid = _paged_inputs(2, *shape)
    kc, ks = jref.absmax_quant_rows_ref(jnp.asarray(kp.reshape(-1, kp.shape[-1])))
    vc, vs = jref.absmax_quant_rows_ref(jnp.asarray(vp.reshape(-1, vp.shape[-1])))
    kq, vq = (np.array(c).reshape(kp.shape) for c in (kc, vc))
    ksc, vsc = (np.array(s).reshape(kp.shape[:3]) for s in (ks, vs))
    want = np.asarray(jpaged.paged_attn_decode_q8(
        *(jnp.asarray(a) for a in (q, kq, vq, ksc, vsc, tables, n_valid))))
    t = [torch.from_numpy(a) for a in (q, kq, vq, ksc, vsc, tables, n_valid)]
    for got in (tpaged.paged_attn_decode_q8(*t), tref.paged_attn_decode_q8_ref(*t)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model's serving steps, teacher-forced from the reference's caches
# ---------------------------------------------------------------------------


def _close(got, want, quantized, where):
    got, want = np.asarray(got), np.asarray(want)
    if quantized:
        np.testing.assert_allclose(np.asarray(jax.nn.softmax(got)),
                                   np.asarray(jax.nn.softmax(want)), atol=5e-3, rtol=0,
                                   err_msg=where)
    else:
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0, err_msg=where)


def test_forward_with_cache_and_dense_decode_match_reference(params):
    """``forward(want_cache, cache_len, last_logits_only)``, ``prefill`` and
    ``decode_step`` (dense cache), each step from the reference's cache."""
    jp, tp = params
    rng = np.random.default_rng(3)
    toks = rng.integers(0, JCFG.vocab_size, size=(2, 9)).astype(np.int32)
    max_len = 14
    jlast, jcache = j_prefill(jp, JCFG, jnp.asarray(toks), max_len=max_len)
    with torch.inference_mode():
        tlast, tcache = prefill(tp, TCFG, torch.from_numpy(toks), max_len=max_len)
        logits, _, none, hidden = forward(tp, TCFG, torch.from_numpy(toks),
                                          last_logits_only=True)
    assert none is None and logits.shape == (2, 1, JCFG.vocab_size)
    assert hidden.shape == (2, 9, JCFG.d_model)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(logits[:, 0].numpy(), np.asarray(jlast), atol=LOGIT_TOL,
                               rtol=0)
    for a, b in zip(jax.tree.leaves(jcache), _leaves(tcache)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
    tok = jnp.argmax(jlast, -1).astype(jnp.int32)
    for pos in range(9, max_len):
        jl, jnext = j_decode_step(jp, JCFG, jcache, tok, pos)
        with torch.inference_mode():
            tl, _ = decode_step(tp, TCFG, _to_port(jcache), torch.from_numpy(
                np.asarray(tok)), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"pos {pos}")
        jcache, tok = jnext, jnp.argmax(jl, -1).astype(jnp.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_steps_match_reference_teacher_forced(params, quantized):
    """Chunked prefill of two prompts, then batched decode steps with idle
    slots, every step run by both packages from the reference's cache; the
    teacher's tokens are the reference's greedy ones."""
    jp, tp = params
    rng = np.random.default_rng(3)
    P, maxp, C, S = 4, 5, 4, 3
    npage = 1 + S * maxp
    prompts = [rng.integers(0, JCFG.vocab_size, size=n).astype(np.int32) for n in (5, 9)]
    jcache = j_init_paged_cache(JCFG, npage, P, quantized=quantized)
    tables = np.zeros((S, maxp), np.int32)
    lengths = np.zeros((S,), np.int32)
    toks = np.zeros((S,), np.int32)
    pages = iter(range(1, npage))
    for s, prompt in enumerate(prompts):
        tables[s] = [next(pages) for _ in range(maxp)]
        for start in range(0, len(prompt), C):
            piece = prompt[start:start + C]
            nv = len(piece)
            piece = np.pad(piece, (0, C - nv))[None]
            jl, jnext = j_paged_prefill_chunk(jp, JCFG, jcache, jnp.asarray(piece),
                                              jnp.int32(start), jnp.asarray(tables[s]),
                                              jnp.int32(nv))
            with torch.inference_mode():
                tl, tcache = paged_prefill_chunk(tp, TCFG, _to_port(jcache),
                                                 torch.from_numpy(piece), start,
                                                 torch.from_numpy(tables[s]), nv)
            _close(tl, jl, quantized, f"prefill slot {s} start {start}")
            if not quantized:
                for a, b in zip(jax.tree.leaves(jnext), _leaves(tcache)):
                    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
            jcache = jnext
        lengths[s], toks[s] = len(prompt), int(jnp.argmax(jl))
    for step in range(4):  # slot 2 idles: length 0, null table row
        args = [jnp.asarray(a) for a in (toks, lengths, np.where(lengths[:, None] > 0,
                                                                 tables, 0))]
        jl, jnext = j_paged_decode_step(jp, JCFG, jcache, *args)
        for backend in ("auto", "ref"):
            with torch.inference_mode():
                tl, _ = paged_decode_step(tp, TCFG, _to_port(jcache),
                                          *(torch.from_numpy(np.asarray(a)) for a in args),
                                          backend=backend)
            for s in range(len(prompts)):
                _close(tl[s], jl[s], quantized, f"step {step} slot {s} {backend}")
        jcache = jnext
        toks = np.asarray(jnp.argmax(jl, -1), np.int32)
        lengths[:len(prompts)] += 1


def test_page_ops_match_reference_exactly():
    """COW copy, swap-out gather (host snapshot) and resume scatter, in place
    in the port, each equal to the reference's new cache."""
    rng = np.random.default_rng(4)
    jcache = jax.tree.map(lambda l: jnp.asarray(rng.normal(size=l.shape), l.dtype),
                          j_init_paged_cache(JCFG, 9, 4))
    src = np.array([3, 5, 0, 0], np.int32)
    dst = np.array([7, 2, 0, 0], np.int32)
    ids = np.array([2, 7, 1, 0], np.int32)
    back = np.array([4, 6, 8, 0], np.int32)

    def same(j, t):
        for a, b in zip(jax.tree.leaves(j), _leaves(t)):
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    tc = _to_port(jcache)
    jc = j_copy(jcache, jnp.asarray(src), jnp.asarray(dst))
    same(jc, paged_copy_pages(tc, src, dst))
    same(jc, tc)  # written in place
    snap_j, snap_t = j_gather(jc, jnp.asarray(ids)), paged_gather_pages(tc, ids)
    same(snap_j, snap_t)
    same(j_scatter(jc, jnp.asarray(back), snap_j), paged_scatter_pages(tc, back, snap_t))


def test_paged_cache_rejects_non_attn_mixer_and_sliding_windows():
    """The paged pool takes global attention only, as the reference's: a
    recurrent mixer and a sliding-window layer raise its ValueError (the
    dense ring cache serves the latter, the O(1) recurrent state the
    former: ``init_cache`` gives the reference's state shapes)."""
    jcfg = j_reduced(j_get_arch("recurrentgemma-2b").model, layers=2, d_model=128)
    cfg = reduced(port_cfg(j_get_arch("recurrentgemma-2b").model), layers=2, d_model=128)
    with pytest.raises(ValueError, match="global-attention"):
        init_paged_cache(cfg, 8, 4, device="cpu")
    local = dataclasses.replace(TCFG, segments=(Segment(period=(LayerSpec("attn_local"),),
                                                        repeat=1),))
    with pytest.raises(ValueError, match="global-attention"):
        init_paged_cache(local, 8, 4, device="cpu")
    from repro_torch.models import init_cache
    assert init_cache(local, 1, 40, device="cpu")[0][0]["k"].shape[2] == local.window
    from repro.models import init_cache as j_init_cache
    want = jax.tree.leaves(j_init_cache(jcfg, 1, 8, jnp.float32))
    got = _leaves(init_cache(cfg, 1, 8, device="cpu"))
    assert [(a.shape, str(a.dtype)) for a in want] == [
        (tuple(b.shape), str(b.dtype).split(".")[1]) for b in got]
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(want, got))


# ---------------------------------------------------------------------------
# the serve loop: greedy streams and reports equal to the reference's
# ---------------------------------------------------------------------------

SPEC = "9:6,3:4,14:5,6:7,2:3"
COUNTERS = ("n_requests", "total_new_tokens", "decode_steps", "prefill_chunks",
            "prefill_tokens", "shared_tokens", "cow_splits", "preemptions", "swapped_pages")


@pytest.fixture(scope="module")
def jsteps(params):
    return jserve.build_paged_steps(params[0], JCFG)


def test_make_workload_matches_reference():
    pairs = jserve.parse_requests(SPEC)
    assert tserve.parse_requests(SPEC) == pairs
    for a, b in zip(tserve.make_workload(TCFG, pairs), jserve.make_workload(JCFG, pairs)):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == np.int32 and (a.rid, a.max_new) == (b.rid, b.max_new)


def _shared_prefix_pairs():
    return [(14, 6), (10, 2), (16, 3)]


def _workload(pkg, cfg, case):
    if case == "share_prefix":  # request 2 extends request 0's prompt
        reqs = pkg.make_workload(cfg, _shared_prefix_pairs())
        reqs[2].prompt = np.concatenate([reqs[0].prompt, reqs[2].prompt[14:]])
        return reqs
    return pkg.make_workload(cfg, jserve.parse_requests(SPEC))


CASES = {
    "f32": dict(),
    "int8": dict(quantized=True),
    "share_prefix": dict(share_prefix=True, npage=17),
    "preempt": dict(npage=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_continuous_streams_match_reference(params, jsteps, case):
    jp, tp = params
    kw = dict(slots=3, page_size=4, chunk=4, **CASES[case])
    jreqs, treqs = _workload(jserve, JCFG, case), _workload(tserve, TCFG, case)
    jrep = jserve.run_continuous(jp, JCFG, jreqs, steps=jsteps, **kw).to_dict()
    trep = tserve.run_continuous(tp, TCFG, treqs, **kw).to_dict()
    assert {k: trep[k] for k in COUNTERS} == {k: jrep[k] for k in COUNTERS}
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    if case == "share_prefix":
        assert trep["shared_tokens"] > 0 and trep["cow_splits"] > 0
    if case == "preempt":
        assert trep["preemptions"] > 0 and trep["swapped_pages"] > 0


def _j_static_streams(jp, reqs, batch):
    """The reference's ``run_static`` loop, keeping each row's greedy tokens
    (the reference times them and drops them)."""
    out = []
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        pmax = max(r.prompt_len for r in group)
        gmax = max(r.max_new for r in group)
        toks = np.zeros((len(group), pmax), np.int32)
        for j, r in enumerate(group):
            toks[j, pmax - r.prompt_len:] = r.prompt
        logits, cache = j_prefill(jp, JCFG, jnp.asarray(toks), max_len=pmax + gmax)
        tok = jnp.argmax(logits, -1)
        rows = [tok]
        for step in range(1, gmax):
            lg, cache = j_decode_step(jp, JCFG, cache, tok, pmax + step - 1)
            tok = jnp.argmax(lg, -1)
            rows.append(tok)
        arr = np.stack([np.asarray(t) for t in rows], axis=1)
        out += [arr[j, :r.max_new].tolist() for j, r in enumerate(group)]
    return out


def test_run_static_streams_match_reference(params):
    jp, tp = params
    pairs = jserve.parse_requests(SPEC)
    treqs = tserve.make_workload(TCFG, pairs)
    rep = tserve.run_static(tp, TCFG, treqs, batch=2)
    jrep = jserve.run_static(jp, JCFG, jserve.make_workload(JCFG, pairs), batch=2)
    assert {k: rep[k] for k in ("n_requests", "total_new_tokens")} == \
        {k: jrep[k] for k in ("n_requests", "total_new_tokens")}
    assert set(rep) == set(jrep)
    want = _j_static_streams(jp, jserve.make_workload(JCFG, pairs), 2)
    assert [r.generated for r in treqs] == want


def test_sampling_at_a_temperature_is_refused(params):
    """Sampling at T = 0.7 is no longer refused: the paged steps' prefill
    draw and ``run_static``'s tokens equal the reference's under the same
    seed (tests/test_torch_sampling.py holds whole streams, near ties
    included; here the draws' top-2 gaps are far from a tie)."""
    jp, tp = params
    toks = np.arange(1, 9, dtype=np.int32)[None] * 7
    row = np.arange(1, 4, dtype=np.int32)
    jsteps_t = jserve.build_paged_steps(jp, JCFG, temperature=0.7, seed=2)
    tsteps = tserve.build_paged_steps(tp, TCFG, temperature=0.7, seed=2)
    jcache = j_init_paged_cache(JCFG, 4, 4)
    tcache = _to_port(jcache)
    for start in (0, 4):  # two chunks: the key splits once a chunk
        jt, jcache = jsteps_t["prefill"](jcache, jnp.asarray(toks[:, start:start + 4]),
                                         jnp.int32(start), jnp.asarray(row), jnp.int32(4))
        tt, tcache = tsteps["prefill"](tcache, toks[:, start:start + 4], start, row, 4)
        assert int(tt) == int(jt)
    reqs = tserve.make_workload(TCFG, [(3, 2)])
    tserve.run_static(tp, TCFG, reqs, batch=1, temperature=0.7, seed=4)
    jreq = jserve.make_workload(JCFG, [(3, 2)])[0]
    logits, cache = j_prefill(jp, JCFG, jnp.asarray(jreq.prompt[None]), max_len=5)
    key, sub = jax.random.split(jax.random.PRNGKey(4))
    tok = jax.random.categorical(sub, logits / 0.7, axis=-1)
    lg, _ = j_decode_step(jp, JCFG, cache, tok, 3)
    key, sub = jax.random.split(key)
    assert reqs[0].generated == [int(tok[0]), int(jax.random.categorical(sub, lg / 0.7)[0])]


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--requests", "6:3,3:2",
                 "--slots", "2", "--page-size", "4", "--chunk", "4", "--quantized"])
    out = capsys.readouterr().out
    assert '"decode_steps"' in out and '"n_requests": 2' in out
