"""The port's serving bundles (``launch/serve_steps.py``) against
``repro.launch.serve_steps``, on a reduced Qwen1.5-0.5B (2 layers, d_model
64), the reference's bundles jitted on a one-device mesh with Auto axes
(ROADMAP C's Explicit-axes entry):

* dense: ``prefill_step`` (last logits) and three teacher-forced
  ``decode_step``s from each side's own cache, within the serve tests'
  ``LOGIT_TOL`` = 1e-4;
* paged: two requests prefilled chunk by chunk into their block-table rows,
  then decode steps over both slots, driven the same way through both
  bundles: greedy token streams equal on f32 and int8 pages, and at T = 0.7
  (keys split per call as the engine splits them) equal up to a token where
  the reference's two largest perturbed logits lie within
  ``test_torch_sampling.SERVE_TIE`` (ROADMAP C's categorical tie rule);
* the paged bundle through the engine (``engine_steps`` into
  ``run_continuous``) gives ``run_continuous``'s own streams, bit for bit;
  a model axis wider than 1 raises;
* a gloo cluster: the same program on 2 processes (4 rows or slots a rank)
  and on 1 (all 8), bit for bit — dense logits, paged tokens and every pool
  page ≥ 1 on every rank — with the bytes the exchanges carried counted by
  kind (the K/V rows each decode step wrote, the tokens, the logits). The
  split changes the row count of every matmul, and the equality rests on
  the BLAS giving each row the same bits at 4 rows as at 8: on this CPU's
  BLAS a (2, 64) × (64, 151936)ᵀ product (2 rows a rank) already differs
  in the last bit from the same rows of the 4-row product (ROADMAP C).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.launch import serve_steps as jss
from repro.models import init_paged_cache as j_init_paged_cache
from repro.models import init_params as j_init_params
from repro.models import paged_decode_step as j_paged_decode_step
from repro.models import reduced as j_reduced
from repro_torch import prng
from repro_torch.configs import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_steps as ss
from repro_torch.launch import topology as topo
from repro_torch.launch.topology import spawn_local_cluster
from repro_torch.launch.transport import RetryPolicy
from repro_torch.models import init_paged_cache
from test_torch_sampling import SERVE_TIE, TEMPERATURE

LOGIT_TOL = 1e-4
JARCH = dataclasses.replace(
    j_get_arch("qwen1.5-0.5b"),
    model=j_reduced(j_get_arch("qwen1.5-0.5b").model, layers=2, d_model=64))
ARCH = ArchConfig(model=port_cfg(JARCH.model))
#: the paged drive: 2 slots, pages of 4, rows of 4 pages, chunks of 4
SLOTS, PAGE, MAXP, CHUNK = 2, 4, 4, 4
NPAGE = 1 + SLOTS * MAXP
PROMPTS = ([5, 9, 13, 2, 7, 11], [3, 1, 4, 1, 5, 9, 2, 6, 5])
DECODE_STEPS = 4


@pytest.fixture(scope="module")
def jmesh():
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jax.random.PRNGKey(0), JARCH.model, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tmesh():
    return topo.make_test_mesh(1, 1, device="cpu")


def test_dense_steps_hold_to_the_reference(jmesh, params):
    jp, tp = params
    B, S, L = 2, 8, 16
    toks = np.random.default_rng(0).integers(0, ARCH.model.vocab_size, (B, S), dtype=np.int32)
    jpre, _ = jss.build_serve_steps(JARCH, jmesh, False, batch=B, seq_len=L, mode="prefill",
                                    dtype=jnp.float32, last_logits=True).fns["prefill_step"]
    jdec, _ = jss.build_serve_steps(JARCH, jmesh, False, batch=B, seq_len=L, mode="decode",
                                    dtype=jnp.float32).fns["decode_step"]
    pre = ss.build_serve_steps(ARCH, _tmesh(), batch=B, seq_len=L, mode="prefill",
                               dtype=torch.float32, last_logits=True)
    dec = ss.build_serve_steps(ARCH, _tmesh(), batch=B, seq_len=L, mode="decode",
                               dtype=torch.float32)
    assert list(pre.fns) == ["prefill_step"] and list(dec.fns) == ["decode_step"]
    jl, jc = jpre(jp, jnp.asarray(toks))
    tl, tc = pre.fns["prefill_step"](tp, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl, axis=-1), dtype=np.int32)  # teacher-forced
        jl, jc = jdec(jp, jc, jnp.asarray(tok), S + step)
        tl, tc = dec.fns["decode_step"](tp, tc, tok, S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {step}")
    # the decode cache the bundle describes is the one prefill lays out
    shapes = [tuple(t.shape) for t in jax.tree.leaves(dec.meta["cache_shapes"])]
    assert shapes == [tuple(t.shape) for t in jax.tree.leaves(tc)]


def _tables() -> np.ndarray:
    return np.stack([1 + s * MAXP + np.arange(MAXP) for s in range(SLOTS)]).astype(np.int32)


def _drive(prefill, decode, cache, keys, gaps=None):
    """Both prompts chunk by chunk, then DECODE_STEPS decode steps over both
    slots. ``prefill`` / ``decode`` take the engine's arguments plus a key
    (None when greedy). Returns the slots' streams and the pool."""
    tables = _tables()
    streams = []
    for s, prompt in enumerate(PROMPTS):
        for start in range(0, len(prompt), CHUNK):
            part = prompt[start:start + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(part)] = part
            tok, cache = prefill(cache, toks, start, tables[s], len(part), keys())
        streams.append([int(tok)])
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    cur = np.array([s[0] for s in streams], np.int32)
    for _ in range(DECODE_STEPS):
        key = keys()
        if gaps is not None:
            gaps.append(gaps_fn(cache, cur, lens, tables, key))
        out, cache = decode(cache, cur, lens, tables, key)
        cur = np.asarray(out, np.int32)
        lens = lens + 1
        for s in range(SLOTS):
            streams[s].append(int(cur[s]))
    return streams, cache


def _keys(seed):
    state = {"key": prng.PRNGKey(seed)}

    def nxt():
        state["key"], sub = prng.split(state["key"])
        return sub
    return nxt


def _j_drive(jp, jmesh, quantized, temperature, seed, gaps=None):
    b = jss.build_paged_serve_steps(JARCH, jmesh, False, n_slots=SLOTS, npage=NPAGE,
                                    page_size=PAGE, max_pages=MAXP, chunk=CHUNK,
                                    dtype=jnp.float32, quantized=quantized,
                                    temperature=temperature)
    dec, _ = b.fns["paged_decode_step"]
    pre, _ = b.fns["paged_prefill_chunk"]
    cache = j_init_paged_cache(JARCH.model, NPAGE, PAGE, jnp.float32, quantized=quantized)
    kw = (lambda k: (jnp.asarray(k),)) if temperature > 0 else (lambda k: ())
    nxt = _keys(seed)
    keys = nxt if temperature > 0 else (lambda: None)
    return _drive(lambda c, t, s, r, n, k: pre(jp, c, jnp.asarray(t), s, jnp.asarray(r), n,
                                               *kw(k)),
                  lambda c, t, ln, tb, k: dec(jp, c, jnp.asarray(t), jnp.asarray(ln),
                                              jnp.asarray(tb), *kw(k)),
                  cache, keys, gaps)


def _t_drive(tp, quantized, temperature, seed, mesh=None):
    b = ss.build_paged_serve_steps(ARCH, mesh or _tmesh(), n_slots=SLOTS, npage=NPAGE,
                                   page_size=PAGE, max_pages=MAXP, chunk=CHUNK,
                                   dtype=torch.float32, quantized=quantized,
                                   temperature=temperature)
    cache = init_paged_cache(ARCH.model, NPAGE, PAGE, torch.float32, quantized=quantized,
                             device="cpu")
    nxt = _keys(seed)
    keys = nxt if temperature > 0 else (lambda: None)
    pre, dec = b.fns["paged_prefill_chunk"], b.fns["paged_decode_step"]
    return _drive(lambda c, t, s, r, n, k: pre(tp, c, t, s, r, n, k),
                  lambda c, t, ln, tb, k: dec(tp, c, t, ln, tb, k), cache, keys)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_greedy_streams_equal_the_reference(jmesh, params, quantized):
    jp, tp = params
    want, _ = _j_drive(jp, jmesh, quantized, 0.0, 0)
    got, _ = _t_drive(tp, quantized, 0.0, 0)
    assert got == want
    assert all(len(s) == 1 + DECODE_STEPS for s in got)


GAPS = {}


def gaps_fn(cache, cur, lens, tables, key):
    """The reference's top-2 gap of each slot's perturbed logits at a
    decode step (its model step on a copy of the pool, the bundle's
    logits × f32(1/T) plus the step key's Gumbel noise)."""
    jp = GAPS["params"]
    lg, _ = j_paged_decode_step(jp, JARCH.model, jax.tree.map(jnp.copy, cache),
                                jnp.asarray(cur), jnp.asarray(lens), jnp.asarray(tables))
    pert = np.asarray(lg * np.float32(1 / np.float32(TEMPERATURE))
                      + jax.random.gumbel(jnp.asarray(key), lg.shape))
    top = np.sort(pert, axis=-1)
    return top[:, -1] - top[:, -2]


def test_paged_sampled_streams_hold_to_the_reference(jmesh, params):
    jp, tp = params
    GAPS["params"] = jp
    gaps: list = []
    want, _ = _j_drive(jp, jmesh, False, TEMPERATURE, 3, gaps)
    got, _ = _t_drive(tp, False, TEMPERATURE, 3)
    greedy, _ = _t_drive(tp, False, 0.0, 0)
    assert got != greedy  # T = 0.7 does sample
    for s in range(SLOTS):
        assert got[s][0] == want[s][0]  # the prefill draws: a one-token margin
        for step in range(DECODE_STEPS):
            if got[s][1 + step] != want[s][1 + step]:
                assert gaps[step][s] < SERVE_TIE, (s, step, gaps[step][s])
                break


def test_engine_steps_give_run_continuous_streams(params):
    _, tp = params
    pairs = [(9, 6), (3, 4), (14, 5), (6, 7)]
    kw = dict(slots=2, page_size=4, chunk=4)
    for quantized, temperature in ((False, 0.0), (True, 0.0), (False, TEMPERATURE)):
        want = tserve.make_workload(ARCH.model, pairs)
        tserve.run_continuous(tp, ARCH.model, want, quantized=quantized,
                              temperature=temperature, seed=2, **kw)
        layout = tserve.paged_layout(want, slots=2, page_size=4)
        b = ss.build_paged_serve_steps(ARCH, _tmesh(), n_slots=2, npage=layout.npage,
                                       page_size=4, max_pages=layout.max_pages, chunk=4,
                                       dtype=torch.float32, quantized=quantized,
                                       temperature=temperature)
        got = tserve.make_workload(ARCH.model, pairs)
        tserve.run_continuous(tp, ARCH.model, got, quantized=quantized,
                              temperature=temperature,
                              steps=ss.engine_steps(b, tp, seed=2), **kw)
        assert [r.generated for r in got] == [r.generated for r in want], (quantized,
                                                                             temperature)


def test_model_axis_raises_and_split_rows():
    mesh = topo.make_test_mesh(2, 2, device="cpu")
    for build, kw in ((ss.build_serve_steps, dict(batch=2, seq_len=8, mode="prefill")),
                      (ss.build_paged_serve_steps, dict(n_slots=2, npage=5, page_size=4,
                                                        max_pages=2, chunk=4))):
        with pytest.raises(NotImplementedError, match="A3"):
            build(ARCH, mesh, **kw)
    # one process: every row on the rank, nothing crosses without a group
    b = ss.build_serve_steps(ARCH, topo.make_test_mesh(4, 1, device="cpu"), batch=4,
                             seq_len=8, mode="decode")
    assert b.meta["rows"] == range(4)


_CLUSTER_PROG = r"""
import hashlib
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_leaves
from repro_torch.launch import topology as topo
from repro_torch.launch.serve_steps import build_paged_serve_steps, build_serve_steps
from repro_torch.models import init_paged_cache, init_params, reduced
import dataclasses

pid, nproc = topo.init_from_env(device="cpu")
mesh = topo.make_test_mesh(nproc * topo.local_workers(), 1, device="cpu")
arch = get_arch("qwen1.5-0.5b")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
params = init_params(0, cfg, torch.float32, device="cpu")
S, P, MAXP, NPAGE, CH = 8, 4, 4, 33, 4
h = hashlib.sha256()

# dense: prefill 8 x 8, then 3 decode steps; logits gathered on every rank
toks = torch.randint(0, cfg.vocab_size, (S, 8), generator=torch.Generator().manual_seed(1))
pre = build_serve_steps(arch, mesh, batch=S, seq_len=12, mode="prefill",
                        dtype=torch.float32, last_logits=True)
dec = build_serve_steps(arch, mesh, batch=S, seq_len=12, mode="decode",
                        dtype=torch.float32)
assert len(pre.meta["rows"]) == S // nproc
logits, cache = pre.fns["prefill_step"](params, toks)
for step in range(3):
    h.update(logits.numpy().tobytes())
    logits, cache = dec.fns["decode_step"](params, cache, torch.argmax(logits, -1), 8 + step)
h.update(logits.numpy().tobytes())
print("DENSE", h.hexdigest())
print("DENSEWIRE", dict(mesh.payload_bytes))
mesh.reset_counts()

# paged: 8 requests prefilled into their rows, 5 decode steps over 8 slots
for quantized, temp in ((False, 0.0), (True, 0.0), (False, 0.7)):
    b = build_paged_serve_steps(arch, mesh, n_slots=S, npage=NPAGE, page_size=P,
                                max_pages=MAXP, chunk=CH, dtype=torch.float32,
                                quantized=quantized, temperature=temp)
    pool = init_paged_cache(cfg, NPAGE, P, torch.float32, quantized=quantized, device="cpu")
    tables = np.stack([1 + s * MAXP + np.arange(MAXP) for s in range(S)]).astype(np.int32)
    key = prng.PRNGKey(7)

    def nxt():
        global key
        key, sub = prng.split(key)
        return sub if temp > 0 else None

    lens, cur = [], []
    for s in range(S):
        prompt = np.arange(3 + s, dtype=np.int32) * (7 + s) % cfg.vocab_size
        for start in range(0, len(prompt), CH):
            part = prompt[start:start + CH]
            t = np.zeros((1, CH), np.int32)
            t[0, :len(part)] = part
            tok, pool = b.fns["paged_prefill_chunk"](params, pool, t, start, tables[s],
                                                     len(part), nxt())
        lens.append(len(prompt))
        cur.append(int(tok))
    lens, cur = np.array(lens, np.int32), np.array(cur, np.int32)
    stream = [cur.tolist()]
    mesh.reset_counts()
    for _ in range(5):
        out, pool = b.fns["paged_decode_step"](params, pool, cur, lens, tables, nxt())
        cur, lens = out.numpy().astype(np.int32), lens + 1
        stream.append(cur.tolist())
    hp = hashlib.sha256()
    for leaf in tree_leaves(pool):
        hp.update(leaf[:, 1:].contiguous().numpy().tobytes())
    tag = f"{'Q8' if quantized else 'F32'}{'T' if temp else ''}"
    print(f"PAGED{tag}", stream)
    print(f"POOL{tag}", hp.hexdigest())
    print(f"WIRE{tag}", dict(mesh.payload_bytes))
    print(f"ROWBYTES{tag}", sum(leaf[:, 0, 0].numel() * leaf.element_size()
                                for leaf in tree_leaves(pool)))
topo.shutdown()
"""

RETRY = RetryPolicy(timeout_s=240.0, retries=2, backoff_s=1.0)


def _parse(out: str, tag: str) -> str:
    m = re.search(rf"^{tag} (.+)$", out, re.M)
    assert m, f"no {tag} line in:\n{out[-2000:]}"
    return m.group(1)


def test_two_ranks_serve_bit_equal_to_one():
    runs = {}
    for nproc, local in ((2, 2), (1, 4)):
        res = spawn_local_cluster(_CLUSTER_PROG, num_processes=nproc, devices_per_process=local,
                                  extra_env={"OMP_NUM_THREADS": "1"}, retry=RETRY)
        for r in res:
            assert r.returncode == 0, r.stderr[-4000:]
        runs[nproc] = [r.stdout for r in res]
    tags = ["DENSE"] + [f"{k}{t}" for k in ("PAGED", "POOL")
                        for t in ("F32", "Q8", "F32T")]
    for tag in tags:
        vals = {_parse(out, tag) for outs in runs.values() for out in outs}
        assert len(vals) == 1, (tag, vals)
    for t in ("F32", "Q8", "F32T"):
        # each decode step: every slot's written K/V rows (one a layer's
        # pool leaf) and its token, summed over the ranks; on one rank too
        for outs in runs.values():
            wires = [eval(_parse(out, f"WIRE{t}")) for out in outs]
            row = int(_parse(outs[0], f"ROWBYTES{t}"))
            assert sum(w["kv_rows"] for w in wires) == 5 * 8 * row, (t, wires)
            assert sum(w["tokens"] for w in wires) == 5 * 8 * 4
    vocab = ARCH.model.vocab_size
    for outs in runs.values():
        wires = [eval(_parse(out, "DENSEWIRE")) for out in outs]
        assert sum(w["logits"] for w in wires) == 4 * 8 * 4 * vocab
