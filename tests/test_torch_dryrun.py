"""``launch/dryrun.py``: the reference's grid and its stand-in of one
production device.

* ``SHAPES``, ``_ORDER``, ``combos()`` and ``perf.VARIANTS``' names equal
  the reference's (read in a subprocess: ``repro.launch.dryrun`` and
  ``repro.launch.perf`` set ``XLA_FLAGS`` at import);
* the stand-in mesh counts what rank 0 of a live mesh counts: on a gloo
  cluster of 4 CPU ranks, a reduced Llama-4-Scout on a (pod 2, data 2,
  model 1) fsdp mesh and a reduced Qwen1.5-0.5B on a (data 2, model 2)
  mesh run sync and compressed rounds (RandK, and the carry); rank 0's
  collectives by kind and by op, counts and bytes, equal the stand-in's
  (``dryrun.StandInMesh`` with the same axes, in this process, on the same
  inputs: its collectives return copies of its own parts, so the values
  differ, the shapes do not), on CPU tensors and on meta ones (the dry
  run's path: the column-split leaves' ragged sizes taken from the key,
  ``transport._cols_counts``, which equal the live draw's counts for every
  data and model rank of a leaf split on both);
* the stand-in's matmul FLOPs (``FlopCounterMode``) of one worker's sync
  round, times its D × m devices, equal the one-rank port's for the same
  worker but for the matmuls the rule table leaves replicated on the model
  axis, which every model rank repeats: here the MoE router, (m − 1) × its
  8·T·d·E a MoE layer (forward, remat's second forward, two backward
  products);
* a whole grid entry on meta (a reduced config has no entry, so
  ``run_one``'s own path at xlstm-350m × long_500k × single is the cheap
  one): every step ``ok``, the reference's JSON keys, the counted memory
  (its argument the entry's input bytes, its peak the entry's).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.launch import dryrun, perf
from repro_torch.launch.topology import spawn_local_cluster
from repro_torch.roofline.memory import counted_peak

ROOT = os.path.join(os.path.dirname(__file__), "..")

_REF_GRID = r"""
import json
from repro.launch import dryrun, perf
print("GRID " + json.dumps({"shapes": dryrun.SHAPES, "order": dryrun._ORDER,
                            "combos": [list(c) for c in dryrun.combos()],
                            "variants": list(perf.VARIANTS)}), flush=True)
"""


def test_grid_and_variants_are_the_references():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _REF_GRID], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(next(x for x in proc.stdout.splitlines()
                          if x.startswith("GRID "))[len("GRID "):])
    assert dryrun.SHAPES == ref["shapes"]
    assert dryrun._ORDER == ref["order"]
    assert [list(c) for c in dryrun.combos()] == ref["combos"]
    assert list(perf.VARIANTS) == ref["variants"]


# (name, arch, mesh shape, axes, multi_pod, fsdp layout, world, model, fsdp)
CASES = [
    ("llama4_fsdp", "llama4-scout-17b-a16e", (2, 2, 1), ("pod", "data", "model"), True, True,
     2, 1, 2),
    ("qwen_model", "qwen1.5-0.5b", (2, 2), ("data", "model"), False, False, 2, 2, 1),
]

_PROG = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["DRYRUN_TESTS"])
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")
import test_torch_dryrun as t
out = {}
for case in t.CASES:
    mesh = topo.make_mesh(case[2], case[3], device="cpu", fsdp=case[5])
    out[case[0]] = t.counted_rounds(case, mesh)
if pid == 0:
    print("COUNTS " + json.dumps(out), flush=True)
topo.shutdown()
"""


def _arch(name: str):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import reduced

    arch = get_arch(name)
    return dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))


def counted_rounds(case, mesh) -> dict:
    """A sync, a RandK and a RandK-with-carry round on ``mesh`` from fixed
    inputs: the mesh's collectives by kind and by op (counts and bytes) a
    round."""
    from repro_torch import prng
    from repro_torch.core.tree_util import tree_map
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.models import init_params

    arch = _arch(case[1])
    cfg = arch.model
    dev = mesh.device
    params = shd.shard_tree(init_params(0, cfg, torch.float32, device=dev), mesh, case[5])
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2, 32), generator=gen).to(dev)}
    kw = dict(global_batch=4, seq_len=32, gamma=0.1, dtype=torch.float32)
    out = {}
    for name, ckw in (("sync", {}), ("randk", {}), ("carry", {"grad_carry": True})):
        b = build_train_steps(arch, mesh, case[4], **kw, **ckw)
        state = [params, tree_map(lambda t: torch.full_like(t, 0.01), params)]
        if ckw:
            state.append(tree_map(lambda t: t.new_zeros((1, *t.shape)), params))
        mesh.reset_counts()
        if name == "sync":
            b.fns["sync_step"](*state, batch)
        else:
            b.fns["compressed_step"](*state, batch, prng.PRNGKey(2))
        out[name] = {k: dict(getattr(mesh, k)) for k in ("collectives", "payload_bytes",
                                                         "op_counts", "op_bytes")}
    return out


def test_stand_in_counts_what_rank_0_counts(monkeypatch):
    from repro_torch.launch import transport as tr

    meta_cols = []
    cols_meta = tr.Transport._uplink_cols_meta

    def counted(self, *a, **kw):
        meta_cols.append(1)
        return cols_meta(self, *a, **kw)

    monkeypatch.setattr(tr.Transport, "_uplink_cols_meta", counted)
    res = spawn_local_cluster(_PROG, num_processes=4, devices_per_process=1, timeout=300.0,
                              extra_env={"DRYRUN_TESTS": os.path.dirname(__file__),
                                         "OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-4000:]
    live = json.loads(next(x for x in res[0].stdout.splitlines()
                           if x.startswith("COUNTS "))[len("COUNTS "):])
    for case in CASES:
        for dev in ("cpu", "meta"):
            mesh = dryrun.StandInMesh(axis_names=case[3], sizes=case[2],
                                      device=torch.device(dev), group="stand-in",
                                      world=case[6], model=case[7], fsdp=case[8])
            got = counted_rounds(case, mesh)
            for rnd, counts in live[case[0]].items():
                assert got[rnd] == counts, (case[0], dev, rnd)
            if case[5]:
                assert any(k.startswith("fsdp/") for k in got["sync"]["collectives"])
    # the meta runs took the column-split leaves' ragged sizes from the key
    assert meta_cols


@pytest.mark.parametrize("j,i", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_meta_column_counts_are_the_draws(j, i):
    """The ragged sizes a meta run takes from the key
    (``transport._cols_counts``) are the live draw's: per worker, the RandK
    offsets of a leaf split over "data" on its rows and over "model" on its
    columns that fall in data rank j's rows and model rank i's columns
    (``Transport._cols_draw``)."""
    from repro_torch import prng
    from repro_torch.launch import transport as tr
    from repro_torch.launch.topology import production_topology

    mesh = dryrun.StandInMesh(axis_names=("pod", "data", "model"), sizes=(2, 2, 2),
                              device=torch.device("cpu"), group="stand-in", world=2,
                              model=2, model_rank=i, fsdp=2, fsdp_rank=j)
    shape = (6, 4, 512)
    t = tr.make_transport(mesh, production_topology(multi_pod=True), ("pod",), 4,
                          param_shapes={"w": torch.empty(shape, device="meta")})
    sp = tr._Split(rows=((0, "fsdp"),), col="model")
    n, lk = 4, prng.PRNGKey(7)
    _idx, mine, *_ = t._cols_draw(lk, shape, sp, n, torch.device("cpu"))
    want = mine.reshape(n, -1).sum(1).tolist()
    assert sum(want) > 0
    assert tr._cols_counts(lk, shape, n, t._cols(shape[-1], "model"),
                           [(0, *t._parts("fsdp"))]) == want


def test_stand_in_flops_sum_to_one_rank():
    from repro_torch.core.tree_util import tree_map
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.launch.topology import Mesh
    from repro_torch.models import init_params
    from repro_torch.roofline import analyze_step

    arch = _arch("llama4-scout-17b-a16e")
    cfg = arch.model
    axes, sizes = ("pod", "data", "model"), (2, 2, 2)
    D, m = 2, 2
    stand = dryrun.StandInMesh(axis_names=axes, sizes=sizes, device=torch.device("cpu"),
                               group="stand-in", world=2, model=m, fsdp=D)
    solo = Mesh(axis_names=axes, sizes=sizes, device=torch.device("cpu"))
    whole = init_params(0, cfg, torch.float32, device="cpu")
    S, per_worker = 64, 4
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, per_worker, S), generator=gen)}
    kw = dict(global_batch=2 * per_worker, seq_len=S, dtype=torch.float32)
    flops = {}
    for key, mesh, params in (("stand", stand, shd.shard_tree(whole, stand, True)),
                              ("one", solo, whole)):
        b = build_train_steps(arch, mesh, True, **kw)
        rep = analyze_step(b.fns["sync_step"], params,
                           tree_map(torch.zeros_like, params), batch)
        flops[key] = rep.flops_per_device
    one_worker = flops["one"] / 2           # the one-rank port runs both workers
    moe_layers = sum(seg.repeat * sum(spec.ff == "moe" for spec in seg.period)
                     for seg in cfg.segments)
    T = per_worker * S
    router = 8 * T * cfg.d_model * cfg.moe.num_experts * moe_layers
    assert moe_layers > 0
    assert flops["stand"] * D * m - one_worker == (m - 1) * router, (flops, router)


def test_one_grid_entry_on_meta():
    res = dryrun.run_one("xlstm-350m", "long_500k", "single")
    assert set(res) == {"arch", "shape", "mesh", "n_devices", "n_workers", "params",
                        "active_params", "local_params", "steps", "wall_s"}
    assert res["n_devices"] == 256
    for name, s in res["steps"].items():
        assert s["ok"], (name, s.get("error"))
        assert s["device"] == "meta" and s["flops_per_device"] > 0
        ma = s["memory_analysis"]
        assert ma["argument_size_in_bytes"] == s["arg_bytes_per_device"] > 0
        assert s["peak_memory_per_device"] == counted_peak(ma) > s["arg_bytes_per_device"]
        assert s["peak_memory_op"] and "memory_vs_allocator" not in s


def test_permk_column_share_may_be_empty():
    """Perm-K on a leaf whose last dimension the model axis splits 16 ways,
    16 workers: C = L/n = 4 lanes a worker, 4 columns a rank, so some
    worker has no lane in device 0's columns; it ships nothing and the
    round runs (on meta, where the gather's wrapper checks its width)."""
    from repro_torch import prng
    from repro_torch.launch.topology import production_topology
    from repro_torch.launch.transport import make_transport

    mesh = dryrun.StandInMesh(axis_names=("data", "model"), sizes=(16, 16),
                              device=torch.device("meta"), group="stand-in", world=16,
                              model=16)
    shapes = {"wq": torch.empty((64, 64), device="meta")}
    tr = make_transport(mesh, production_topology(), ("data",), 16, compression="permk",
                        param_shapes=shapes)
    leaf = torch.empty((1, 64, 4), device="meta")
    lanes = torch.from_numpy(prng.permutation(prng.split(prng.PRNGKey(3), 1)[0], 64))
    assert any(not ((w >= 0) & (w < 4)).any() for w in lanes.reshape(16, 4))
    out = tr.uplink_mean(prng.PRNGKey(3), {"wq": leaf})
    assert tuple(out["wq"].shape) == (64, 4)
