"""The model axis beyond the training rounds: the rule table applied
(``sharding.shard_tree`` / ``gather_tree``) for all ten configs, the fsdp
refusal (ROADMAP A3c), and on a 2-rank gloo cluster (one worker group, two
model ranks) the families and the serving bundles against one rank.

* ``shard_tree`` then ``gather_tree`` gives the whole tree back, bit for
  bit, for the meta shapes of all ten configs at m = 2 and 4 (the slices of
  each model rank, concatenated along the leaf's model dimension, as the
  model group's all-gather does; real bits on reduced configs);
* reduced Llama-4-Scout (MoE: experts split over the model ranks),
  DeepSeek-V3 (MLA gathered on use, the MoE and the MTP head) and
  xlstm-350m (the recurrent mixers gathered on use): the loss and every
  gradient within the LM rule (1e-4 of each leaf's scale; the loss within
  rtol 1e-5) of the one-rank port, and Qwen1.5-0.5B's loss and gradients
  too;
* the dense serving bundle (prefill + 3 decode steps, the logits gathered
  over the vocabulary) and the paged one through the engine
  (``engine_steps`` into ``run_continuous``) on f32 and int8 pages and at
  T = 0.7: the logits within 1e-5 of the largest and the token streams
  equal to the one-rank port's, each model rank holding its half of the KV
  heads of the pool.
"""

import dataclasses
import json

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.tree_util import tree_flatten
from repro_torch.launch import sharding as shd
from repro_torch.launch import topology as topo
from repro_torch.launch.distributed import build_train_steps
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


def test_fsdp_inner_axis_raises_naming_a3c():
    arch = get_arch("llama4-scout-17b-a16e")
    assert arch.fsdp and arch.worker_axes == "pod"
    mesh = topo.Mesh(axis_names=("pod", "data", "model"), sizes=(2, 2, 1),
                     device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="A3c"):
        build_train_steps(dataclasses.replace(arch, model=reduced(arch.model, layers=2,
                                                                  d_model=64)),
                          mesh, True, global_batch=4, seq_len=16, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="A3c"):
        shd.shard_tree({}, mesh, fsdp=True)


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
                     ("xlstm-350m", 8), ("qwen1.5-0.5b", 2)):
    cfg = reduced(get_arch(name).model, layers=layers, d_model=64)
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
    for name in ("llama4-scout-17b-a16e", "deepseek-v3-671b", "xlstm-350m", "qwen1.5-0.5b"):
        loss_err, grad_err = got[name]
        assert loss_err <= 1e-5 and grad_err <= 1e-4, (name, loss_err, grad_err)
    assert got["dense_logits"] <= 1e-5, got["dense_logits"]
    for key in ("paged_0_0.0", "paged_1_0.0", "paged_0_0.7"):
        same, kinds = got[key]
        assert same, key
        assert "model/sum" in kinds and "model/pick" in kinds, (key, kinds)
