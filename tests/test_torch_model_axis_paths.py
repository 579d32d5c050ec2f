"""The model axis beyond the training rounds: the rule table applied
(``sharding.shard_tree`` / ``gather_tree``) for all ten configs, with the
fsdp data axis too, and on a 2-rank gloo cluster (one worker group, two
model ranks) the families and the serving bundles against one rank.

* ``shard_tree`` then ``gather_tree`` gives the whole tree back, bit for
  bit, for the meta shapes of all ten configs at m = 2 and 4 (the slices of
  each model rank, concatenated along the leaf's model dimension, as the
  model group's all-gather does; real bits on reduced configs), and with
  the fsdp data axis on at full width on both production meshes;
* a rank's shard shapes on the (16, 16) and (2, 16, 16) meshes are the
  reference's specs' (``repro.launch.sharding.param_spec`` on a JAX
  ``AbstractMesh``, each dimension ÷ the sizes of the axes its spec names)
  for all ten configs, and the per-device parameter counts of Llama-4-Scout
  and DeepSeek-V3 on the two-pod mesh are 421,211,568 and 2,672,981,504
  with the fsdp split (6,735,621,888 and 42,664,807,424 without); a
  serving device of the dry run's stand-in holds the reference's serving
  slices (an fsdp arch's ``F`` roles over "data" on both meshes) and the
  decode rows its ``serve_batch_axes`` leave it;
* reduced Llama-4-Scout (MoE: experts split over the model ranks),
  DeepSeek-V3 (MLA gathered on use, the MoE and the MTP head),
  xlstm-350m (the recurrent mixers gathered on use) and internvl2-1b (an
  odd vocabulary: the table split on d by the rule table's fallback and
  gathered on use along it): the loss and every
  gradient within the LM rule (1e-4 of each leaf's scale; the loss within
  rtol 1e-5) of the one-rank port, and Qwen1.5-0.5B's loss and gradients
  too;
* the dense serving bundle (prefill + 3 decode steps, the logits gathered
  over the vocabulary) and the paged one through the engine
  (``engine_steps`` into ``run_continuous``) on f32 and int8 pages and at
  T = 0.7: the logits within 1e-5 of the largest and the token streams
  equal to the one-rank port's, each model rank holding its half of the KV
  heads of the pool; and the dense bundles of two GQA layouts whose heads
  do not split over the ranks (3 query heads: the layer and its cache
  whole; 4 query / 1 KV: the KV of the rank's query heads) within 1e-5 of
  one rank's logits.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.tree_util import tree_flatten, tree_flatten_with_path
from repro_torch.launch import sharding as shd
from repro_torch.launch import topology as topo
from repro_torch.launch.topology import spawn_local_cluster
from repro_torch.models import init_params, reduced


class _Ranks:
    """The m model ranks of one worker group, in one process: rank i's
    ``model_slice``, and the group's all-gather as the concatenation."""

    def __init__(self, m: int, i: int = 0):
        self.model, self.model_rank = m, i
        self.shape = {"data": 4, "model": m}

    def model_slice(self, t, dim):
        return t.chunk(self.model, dim=dim)[self.model_rank].contiguous()


def _round_trip(tree, m: int):
    parts = [shd.shard_tree(tree, _Ranks(m, i)) for i in range(m)]
    leaves, treedef = tree_flatten(tree)
    dims = shd.model_dims(tree, _Ranks(m))
    cols = [tree_flatten(p)[0] for p in parts]
    out = []
    for j, (t, d) in enumerate(zip(leaves, dims)):
        if d is None:
            assert all(c[j] is t for c in cols)
            out.append(t)
            continue
        assert all(tuple(c[j].shape) == shd.local_shape(t.shape, d, m) for c in cols)
        out.append(torch.cat([c[j] for c in cols], dim=d))
    return treedef.unflatten(out), dims


@pytest.mark.parametrize("m", [2, 4])
def test_shard_then_gather_is_the_whole_tree(m):
    for name in ARCH_IDS:
        shapes = init_params(0, get_arch(name).model, torch.float32, device="meta")
        back, dims = _round_trip(shapes, m)
        for a, b in zip(tree_flatten(shapes)[0], tree_flatten(back)[0]):
            assert a.shape == b.shape and a.dtype == b.dtype, name
        assert any(d is not None for d in dims), name
    params = init_params(0, reduced(get_arch("qwen1.5-0.5b").model, layers=2, d_model=64),
                         torch.float32, device="cpu")
    back, _ = _round_trip(params, m)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(back)[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


class _Grid:
    """The D × m inner ranks of one worker group of a production mesh, in
    one process: rank (j, i)'s ``fsdp_slice`` / ``model_slice``."""

    def __init__(self, multi_pod: bool, j: int = 0, i: int = 0):
        shape, axes = topo.PRODUCTION_SHAPES[multi_pod]
        self.shape = dict(zip(axes, shape))
        self.model, self.model_rank = self.shape["model"], i
        self.fsdp, self.fsdp_rank = self.shape["data"], j

    def model_slice(self, t, dim):
        return t.chunk(self.model, dim=dim)[self.model_rank].contiguous()

    def fsdp_slice(self, t, dim):
        return t.chunk(self.fsdp, dim=dim)[self.fsdp_rank].contiguous()


def _fsdp_of(name: str, multi_pod: bool) -> bool:
    """The fsdp flag ``build_train_steps`` derives: an fsdp arch whose
    workers are pods, on the two-pod mesh."""
    arch = get_arch(name)
    return arch.fsdp and "data" not in topo.worker_axis_names(multi_pod, arch.worker_axes)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fsdp_shard_then_gather_is_the_whole_tree(multi_pod):
    """``shard_tree`` with the data axis on, then the slices of the D × m
    ranks concatenated (model dimension first, then data, as
    ``gather_tree``'s gathers do), is the whole tree, for every config at
    full width (meta shapes) and for a reduced Llama-4-Scout's real bits."""
    probe = [0, 15] if multi_pod else [0]

    def round_trip(tree, fsdp, ranks):
        leaves, treedef = tree_flatten(tree)
        g = _Grid(multi_pod)
        splits = shd.leaf_splits(tree, g, fsdp)
        if fsdp:
            assert any(fd is not None for fd, _md in splits)
        parts = {(j, i): tree_flatten(shd.shard_tree(tree, _Grid(multi_pod, j, i), fsdp))[0]
                 for j in ranks for i in ranks}
        for k, (t, (fd, md)) in enumerate(zip(leaves, splits)):
            want = list(t.shape)
            for d, n in ((fd, g.fsdp), (md, g.model)):
                if d is not None:
                    want[d] //= n
            for p in parts.values():
                assert list(p[k].shape) == want
        return splits

    for name in ARCH_IDS:
        shapes = init_params(0, get_arch(name).model, torch.float32, device="meta")
        round_trip(shapes, _fsdp_of(name, multi_pod), probe)
    if not multi_pod:
        return
    # real bits: a reduced config, every (j, i) of a (2, 2)-wide worker
    cfg = reduced(get_arch("llama4-scout-17b-a16e").model, layers=2, d_model=64)
    params = init_params(0, cfg, torch.float32, device="cpu")

    class Small(_Grid):
        def __init__(self, j=0, i=0):
            self.shape = {"pod": 2, "data": 2, "model": 2}
            self.model, self.model_rank, self.fsdp, self.fsdp_rank = 2, i, 2, j

    splits = shd.leaf_splits(params, Small(), True)
    parts = {(j, i): tree_flatten(shd.shard_tree(params, Small(j, i), True))[0]
             for j in range(2) for i in range(2)}
    for k, (t, (fd, md)) in enumerate(zip(tree_flatten(params)[0], splits)):
        rows = []
        for j in range(2):
            row = [parts[(j, i)][k] for i in range(2)]
            rows.append(row[0] if md is None else torch.cat(row, dim=md))
        back = rows[0] if fd is None else torch.cat(rows, dim=fd)
        assert torch.equal(back.view(torch.int32), t.view(torch.int32))


def _ref_local_shape(name: str, multi_pod: bool, fsdp=None) -> list:
    """The reference's per-device shapes: its ``param_spec`` on an
    ``AbstractMesh`` of the production axes, each dimension ÷ its axes
    (``fsdp``: the flag it is given; by default the training one)."""
    import jax
    from repro.launch import sharding as jshd

    shape, axes = topo.PRODUCTION_SHAPES[multi_pod]
    mesh = jax.sharding.AbstractMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    flat, _ = tree_flatten_with_path(init_params(0, get_arch(name).model, torch.float32,
                                                 device="meta"))
    fsdp = _fsdp_of(name, multi_pod) if fsdp is None else fsdp
    out = []
    for path, leaf in flat:
        spec = jshd.param_spec(path, leaf, mesh, fsdp)
        local = list(leaf.shape)
        for d, ax in enumerate(tuple(spec)):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                local[d] //= sizes[a]
        out.append(local)
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fsdp_shard_shapes_are_the_reference_specs(multi_pod):
    for name in ARCH_IDS:
        shapes = init_params(0, get_arch(name).model, torch.float32, device="meta")
        local = shd.shard_tree(shapes, _Grid(multi_pod), _fsdp_of(name, multi_pod))
        assert [list(t.shape) for t in tree_flatten(local)[0]] == \
            _ref_local_shape(name, multi_pod), name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fsdp_serving_shards_are_the_reference_specs(multi_pod):
    """A serving device of the dry run's stand-in mesh (``stand_in_mesh(...,
    serve=True)``) holds the reference's serving slices — its
    ``serve_steps`` calls ``param_sharding_tree(..., arch.fsdp)``, so an
    fsdp arch's ``F`` roles split over "data" on the single-pod mesh too —
    and computes the rows of the decode batch that the reference's
    ``serve_batch_axes`` leave a device."""
    import jax
    from repro.launch import sharding as jshd

    from repro_torch.launch import dryrun
    from repro_torch.launch.serve_steps import build_serve_steps

    shape, axes = topo.PRODUCTION_SHAPES[multi_pod]
    jmesh = jax.sharding.AbstractMesh(shape, axes)
    B = dryrun.SHAPES["decode_32k"]["global_batch"]
    per = B // int(np.prod([jmesh.shape[a] for a in jshd.serve_batch_axes(jmesh, B)]))
    for name in ARCH_IDS:
        arch = get_arch(name)
        mesh = dryrun.stand_in_mesh(arch, multi_pod, "meta", serve=True)
        b = build_serve_steps(arch, mesh, batch=B, seq_len=64, mode="decode",
                              dtype=torch.float32)
        assert [list(t.shape) for t in tree_flatten(b.local_shapes)[0]] == \
            _ref_local_shape(name, multi_pod, arch.fsdp), name
        assert len(b.meta["rows"]) == per, (name, b.meta["rows"])


@pytest.mark.parametrize("name,without,with_fsdp", [
    ("llama4-scout-17b-a16e", 6_735_621_888, 421_211_568),
    ("deepseek-v3-671b", 42_664_807_424, 2_672_981_504),
])
def test_fsdp_per_device_parameter_counts(name, without, with_fsdp):
    """One device's parameters on the (2, 16, 16) mesh, with and without
    the fsdp split of the ``F`` roles."""
    shapes = init_params(0, get_arch(name).model, torch.float32, device="meta")
    for fsdp, want in ((False, without), (True, with_fsdp)):
        local = shd.shard_tree(shapes, _Grid(True), fsdp)
        assert sum(t.numel() for t in tree_flatten(local)[0]) == want, (name, fsdp)


def test_pools_split_the_kv_heads_as_cache_leaf_spec_does():
    """A rank's page pool (``init_paged_cache(model=m)``) is ``cache_leaf_spec``'s
    split of the whole pool: the KV-head dimension of the f32 pages and the
    int8 codes, for Qwen1.5-0.5B at m = 2 and 4. The int8 scales, (repeat,
    npage, P, KV), go with their codes on the KV heads, where the rule table
    would split the page rows P (ROADMAP C)."""
    from repro_torch.core.tree_util import tree_flatten_with_path
    from repro_torch.models import init_paged_cache

    cfg = get_arch("qwen1.5-0.5b").model
    for m in (2, 4):
        for quantized in (False, True):
            whole = init_paged_cache(cfg, 9, 16, torch.float32, quantized=quantized,
                                     device="meta")
            local = init_paged_cache(cfg, 9, 16, torch.float32, quantized=quantized,
                                     device="meta", model=m)
            for (path, w), lo in zip(tree_flatten_with_path(whole)[0], tree_flatten(local)[0]):
                d = shd.model_dim(shd.cache_leaf_spec(path, w, _Ranks(m), None))
                name = shd._leaf_name(path)
                assert d == (2 if name.endswith("_scale") else 3), (name, d)
                assert tuple(lo.shape) == shd.local_shape(w.shape, 3, m), (name, lo.shape)


_PROG = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")
from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_flatten, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_steps as ss
from repro_torch.launch import sharding as shd
from repro_torch.models import init_params, lm_loss, reduced
import dataclasses

mesh = topo.make_test_mesh(2, 2, device="cpu")
assert mesh.model == 2 and mesh.world == 1
solo = topo.Mesh(axis_names=("data", "model"), sizes=(2, 2), device=torch.device("cpu"))
res = {}


def grads(p, cfg, toks, tp):
    leaves, td = tree_flatten(p)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = lm_loss(tree_unflatten(td, leaves), cfg, toks, tp=tp)
    return float(loss), torch.autograd.grad(loss, leaves)


for name, layers in (("llama4-scout-17b-a16e", 2), ("deepseek-v3-671b", 4),
                     ("xlstm-350m", 8), ("qwen1.5-0.5b", 2), ("internvl2-1b", 2)):
    cfg = reduced(get_arch(name).model, layers=layers, d_model=64)
    if name == "internvl2-1b":
        # its own odd vocabulary (151,655; reduced() shrinks it), so the rule
        # table's fallback splits the table on d
        cfg = dataclasses.replace(cfg, vocab_size=get_arch(name).model.vocab_size)
        assert shd.model_dims({"embed": init_params(0, cfg, device="meta")["embed"]},
                              mesh) == [1]
    params = init_params(0, cfg, torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    l1, g1 = grads(params, cfg, toks, None)
    l2, g2 = grads(shd.shard_tree(params, mesh), cfg, toks, mesh)
    whole = tree_flatten(shd.gather_tree(tree_unflatten(tree_flatten(params)[1], list(g2)),
                                         mesh, params))[0]
    err = max(float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)
              for a, b in zip(g1, whole))
    res[name] = [abs(l1 - l2) / abs(l1), err]

arch = get_arch("qwen1.5-0.5b")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
params = init_params(0, cfg, torch.float32, device="cpu")
local = shd.shard_tree(params, mesh)
S = 4
toks = torch.randint(0, cfg.vocab_size, (S, 8), generator=torch.Generator().manual_seed(2))
logit_err = 0.0
streams = {}
for m, p in ((mesh, local), (solo, params)):
    pre = ss.build_serve_steps(arch, m, batch=S, seq_len=12, mode="prefill",
                               dtype=torch.float32, last_logits=True)
    dec = ss.build_serve_steps(arch, m, batch=S, seq_len=12, mode="decode",
                               dtype=torch.float32)
    logits, cache = pre.fns["prefill_step"](p, toks)
    seq = [logits]
    for step in range(3):
        logits, cache = dec.fns["decode_step"](p, cache, torch.argmax(seq[-1], -1), 8 + step)
        seq.append(logits)
    streams[m is mesh] = seq
    if m is mesh:
        kv = [t.shape for t in tree_flatten(cache)[0]]
        assert all(s[3] == cfg.num_kv_heads // 2 for s in kv), kv
for a, b in zip(streams[True], streams[False]):
    assert a.shape == b.shape == (S, cfg.vocab_size)
    logit_err = max(logit_err, float((a - b).abs().max() / b.abs().max()))
res["dense_logits"] = logit_err

# GQA layers whose heads do not split over the ranks: 3 query heads (the
# layer runs whole, its cache whole) and 4 query / 1 KV head (the KV of the
# rank's query heads)
heads = {}
for H, KV in ((3, 1), (4, 1)):
    hcfg = dataclasses.replace(cfg, d_model=48, num_heads=H, num_kv_heads=KV, head_dim=16)
    harch = dataclasses.replace(arch, model=hcfg)
    hp = init_params(0, hcfg, torch.float32, device="cpu")
    seqs = {}
    for m, p in ((mesh, shd.shard_tree(hp, mesh)), (solo, hp)):
        pre = ss.build_serve_steps(harch, m, batch=S, seq_len=12, mode="prefill",
                                   dtype=torch.float32, last_logits=True)
        dec = ss.build_serve_steps(harch, m, batch=S, seq_len=12, mode="decode",
                                   dtype=torch.float32)
        logits, cache = pre.fns["prefill_step"](p, toks)
        seq = [logits]
        for step in range(3):
            logits, cache = dec.fns["decode_step"](p, cache, torch.argmax(seq[-1], -1), 8 + step)
            seq.append(logits)
        seqs[m is mesh] = seq
    heads[f"{H}_{KV}"] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(seqs[True], seqs[False]))
res["heads"] = heads

pairs = [(9, 6), (3, 4), (14, 5), (6, 7)]
kw = dict(slots=2, page_size=4, chunk=4)
for quantized, temperature in ((False, 0.0), (True, 0.0), (False, 0.7)):
    want = tserve.make_workload(cfg, pairs)
    tserve.run_continuous(params, cfg, want, quantized=quantized, temperature=temperature,
                          seed=2, **kw)
    layout = tserve.paged_layout(want, slots=2, page_size=4)
    b = ss.build_paged_serve_steps(arch, mesh, n_slots=2, npage=layout.npage, page_size=4,
                                   max_pages=layout.max_pages, chunk=4, dtype=torch.float32,
                                   quantized=quantized, temperature=temperature)
    kv = [t.shape for t in tree_flatten(b.meta["cache_shapes"])[0]]
    assert all(s[3] == cfg.num_kv_heads // 2 for s in kv), kv
    got = tserve.make_workload(cfg, pairs)
    mesh.reset_counts()
    tserve.run_continuous(local, cfg, got, quantized=quantized, temperature=temperature,
                          steps=ss.engine_steps(b, local, seed=2), **kw)
    res[f"paged_{int(quantized)}_{temperature}"] = [
        [r.generated for r in got] == [r.generated for r in want],
        sorted(mesh.collectives)]
print("RES " + json.dumps(res), flush=True)
topo.shutdown()
"""


def test_two_model_ranks_families_and_serving():
    res = spawn_local_cluster(_PROG, num_processes=2, devices_per_process=1, timeout=420.0,
                              extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-4000:]
    outs = [json.loads(line[4:]) for r in res for line in r.stdout.splitlines()
            if line.startswith("RES ")]
    assert len(outs) == 2 and outs[0] == outs[1]
    got = outs[0]
    for name in ("llama4-scout-17b-a16e", "deepseek-v3-671b", "xlstm-350m", "qwen1.5-0.5b",
                 "internvl2-1b"):
        loss_err, grad_err = got[name]
        assert loss_err <= 1e-5 and grad_err <= 1e-4, (name, loss_err, grad_err)
    assert got["dense_logits"] <= 1e-5, got["dense_logits"]
    assert all(e <= 1e-5 for e in got["heads"].values()), got["heads"]
    for key in ("paged_0_0.0", "paged_1_0.0", "paged_0_0.7"):
        same, kinds = got[key]
        assert same, key
        assert "model/sum" in kinds and "model/pick" in kinds, (key, kinds)
