"""The fsdp inner axis, continued (``test_torch_fsdp.py``'s module doc
says what is checked): packed QSGD (s = 7) and PP (1, "without") with the
carry on the 4-rank (2, 2, 1) gloo cluster against the reference's sharded
program and the one-rank port, and the MoE capacity trap — one MoE layer
at capacity factor 0.5 on each data rank's rows equal to the one-rank
whole-batch dispatch (outputs, dropped pairs, aux loss and its gradient),
and a sync round of that model within the LM rule of one rank.
"""

from _torch_fsdp import check_moe, run_against_reference
from _torch_parity import one_torch_thread  # noqa: F401


def test_fsdp_qsgd_pp_and_moe_capacity(tmp_path):
    results = run_against_reference(tmp_path, ("qsgd", "pp"), (4,), moe=True)
    check_moe(results[4])


_SERVE_PROG = r"""
import json
import torch
torch.set_num_threads(1)
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")
import dataclasses
from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_flatten, tree_unflatten
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_steps as ss
from repro_torch.launch import sharding as shd
from repro_torch.models import init_params, lm_loss, reduced
from repro_torch.models.layers import RowSplit

mesh = topo.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu", fsdp=True)
solo = topo.Mesh(axis_names=("pod", "data", "model"), sizes=(2, 2, 1),
                 device=torch.device("cpu"))
res = {}

# training passes of the families: each data rank's rows, the shares added
for name, layers in (("llama4-scout-17b-a16e", 2), ("deepseek-v3-671b", 4)):
    cfg = reduced(get_arch(name).model, layers=layers, d_model=64)
    params = init_params(0, cfg, torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
    leaves, td = tree_flatten(params)
    one = torch.autograd.grad(lm_loss(tree_unflatten(td, [t.requires_grad_(True) for t in leaves]),
                                      cfg, toks), leaves)
    splits = shd.leaf_splits(params, mesh, True)
    local = tree_flatten(shd.shard_tree(params, mesh, True))[0]
    local = [t.detach().requires_grad_(True) for t in local]
    j = mesh.fsdp_rank
    g = torch.autograd.grad(lm_loss(tree_unflatten(td, local), cfg, toks[2 * j:2 * j + 2],
                                    tp=RowSplit(mesh)), local)
    g = [mesh.fsdp_sum(t) if fd is None else t for t, (fd, _md) in zip(g, splits)]
    whole = tree_flatten(shd.gather_tree(tree_unflatten(td, g), mesh, params, True))[0]
    res[name] = max(float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)
                    for a, b in zip(one, whole))

arch = get_arch("llama4-scout-17b-a16e")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
params = init_params(0, cfg, torch.float32, device="cpu")
local = shd.shard_tree(params, mesh, True)
# a serving rank holds 1/D of each F leaf
held = []
for t, w, (fd, _md) in zip(tree_flatten(local)[0], tree_flatten(params)[0],
                           shd.leaf_splits(params, mesh, True)):
    held.append(tuple(t.shape) == tuple(w.shape) if fd is None
                else t.shape[fd] * 2 == w.shape[fd])
res["held"] = [all(held), sum(fd is not None for fd, _ in shd.leaf_splits(params, mesh, True))]
# the single-pod layout: the data axis of (4, 1) is the fsdp axis, no pod
flat = topo.make_mesh((4, 1), ("data", "model"), device="cpu", fsdp=True)
assert (flat.world, flat.fsdp) == (1, 4)
flat_local = shd.shard_tree(params, flat, True)
S = 4
toks = torch.randint(0, cfg.vocab_size, (S, 8), generator=torch.Generator().manual_seed(2))


def dense(m, p, B):
    pre = ss.build_serve_steps(arch, m, batch=B, seq_len=12, mode="prefill",
                               dtype=torch.float32, last_logits=True)
    dec = ss.build_serve_steps(arch, m, batch=B, seq_len=12, mode="decode",
                               dtype=torch.float32)
    logits, cache = pre.fns["prefill_step"](p, toks[:B])
    seq = [logits]
    for step in range(3):
        logits, cache = dec.fns["decode_step"](p, cache, torch.argmax(seq[-1], -1), 8 + step)
        seq.append(logits)
    return seq, len(pre.meta["rows"]), len(dec.meta["rows"])


def err(a, b):
    return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))


# S = 4 rows split over (pod, data) on both layouts; 2 rows over the pods
# only on the two-pod mesh (the data ranks compute the same rows), and
# over the data ranks on the single-pod one
res["dense_logits"], res["dense_rows"] = [], []
for m, p in ((mesh, local), (flat, flat_local)):
    for B in (4, 2):
        want_seq = dense(solo, params, B)[0]
        m.reset_counts()
        seq, *rows = dense(m, p, B)
        res["dense_logits"].append(err(seq, want_seq))
        res["dense_rows"].append(rows + [sorted(k for k in m.collectives
                                                if k.endswith("logits"))])
# a long prefill's rows weigh more than the table: the row-split ranks
# gather the tables on use
long = torch.randint(0, cfg.vocab_size, (S, 40), generator=torch.Generator().manual_seed(3))
lp = {}
for m, p in ((mesh, local), (solo, params)):
    b = ss.build_serve_steps(arch, m, batch=S, seq_len=48, mode="prefill",
                             dtype=torch.float32)
    m.reset_counts()
    lp[m is mesh] = b.fns["prefill_step"](p, long)[0]
res["long_prefill"] = [err([lp[True]], [lp[False]]), sorted(mesh.collectives)]
pairs = [(9, 6), (3, 4), (14, 5), (6, 7)]
res["paged"] = []
for m, p, slots in ((mesh, local, 2), (mesh, local, 4), (flat, flat_local, 4)):
    kw = dict(slots=slots, page_size=4, chunk=4)
    want = tserve.make_workload(cfg, pairs)
    tserve.run_continuous(params, cfg, want, **kw)
    layout = tserve.paged_layout(want, slots=slots, page_size=4)
    b = ss.build_paged_serve_steps(arch, m, n_slots=slots, npage=layout.npage, page_size=4,
                                   max_pages=layout.max_pages, chunk=4, dtype=torch.float32)
    got = tserve.make_workload(cfg, pairs)
    m.reset_counts()
    tserve.run_continuous(p, cfg, got, steps=ss.engine_steps(b, p), **kw)
    res["paged"].append([[r.generated for r in got] == [r.generated for r in want],
                         len(b.meta["rows"]),
                         sorted(k for k in m.collectives if k.startswith("fsdp/"))])
# a live mesh whose data axis spans ranks, not laid out for fsdp, is refused
try:
    ss.build_serve_steps(arch, topo.make_mesh((4, 1), ("data", "model"), device="cpu"),
                         batch=S, seq_len=12, mode="decode", dtype=torch.float32)
    res["refused"] = False
except ValueError:
    res["refused"] = True
print("RES " + json.dumps(res), flush=True)
topo.shutdown()
"""


def test_fsdp_families_and_serving_on_four_ranks():
    """On a (2, 2, 1) fsdp mesh of 4 gloo ranks: a reduced Llama-4-Scout's
    and DeepSeek-V3's (MLA, MoE, the MTP head) gradient, each data rank on
    its rows of the worker's batch, within the LM rule of one rank's over
    the whole batch; an fsdp arch's serving rank holding 1/D of every F
    leaf (``serve_steps`` ignored ``arch.fsdp`` before this slice: ROADMAP
    C), on the two-pod layout and on the single-pod one ((4, 1): "data"
    the fsdp axis, as the reference splits serving parameters wherever the
    mesh has it): its dense prefill + decode logits within 1e-5 of one
    rank's and its paged streams one rank's, the rows (slots) split over
    the pods and the data ranks where they divide (a rank's rows, the
    outputs crossing the data group as ``fsdp/logits``; a decode step's
    looked-up rows and partial logits crossing it, a long prefill's tables
    gathered), the F split gathered on use (``fsdp/...``); a data axis
    spanning ranks on a mesh not laid out for fsdp is refused."""
    from repro_torch.launch.topology import spawn_local_cluster

    res = spawn_local_cluster(_SERVE_PROG, num_processes=4, devices_per_process=1,
                              timeout=420.0, extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-4000:]
    import json

    outs = [json.loads(line[4:]) for r in res for line in r.stdout.splitlines()
            if line.startswith("RES ")]
    assert len(outs) == 4
    for got in outs:
        for name in ("llama4-scout-17b-a16e", "deepseek-v3-671b"):
            assert got[name] <= 1e-4, (name, got[name])
        assert got["held"][0] and got["held"][1] > 0, got["held"]
        assert max(got["dense_logits"]) <= 1e-5, got["dense_logits"]
        # (prefill rows, decode rows, output kinds): (2, 2, 1) at B = 4, 2;
        # (4, 1) at B = 4, 2
        # (the data ranks' partial logits over their columns summed where
        # they compute the same rows)
        assert got["dense_rows"] == [
            [1, 1, ["fsdp/logits", "fsdp/partial_logits", "logits"]],
            [1, 1, ["fsdp/partial_logits", "logits"]],
            [1, 1, ["fsdp/logits", "fsdp/partial_logits"]],
            [2, 2, ["fsdp/partial_logits"]]], got["dense_rows"]
        e, kinds = got["long_prefill"]
        assert e <= 1e-5 and "fsdp/embed_rows" not in kinds, got["long_prefill"]
        assert "fsdp/partial_logits" not in kinds, kinds
        for k, (same, rows, kinds) in enumerate(got["paged"]):
            assert same and rows == 1, got["paged"]
            assert "fsdp/gather_on_use" in kinds, kinds
            # a rank's own slot: its rows cross, not the tables
            assert ("fsdp/embed_rows" in kinds) == (k > 0), kinds
            # the stacked norms split over their 2 layers where D = 2 divides
            assert ("fsdp/norms" in kinds) == (k < 2), kinds
        assert "fsdp/kv_rows" not in got["paged"][0][2]
        assert "fsdp/kv_rows" in got["paged"][1][2] and "fsdp/tokens" in got["paged"][2][2]
        assert got["refused"]
