"""Shared by ``test_torch_fsdp.py`` and ``test_torch_fsdp_paths.py`` (their
module docs say what is checked): the reference's sharded program, the
port's gloo clusters, and the checks.
"""

import ast
import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np

from repro_torch.launch.topology import spawn_local_cluster

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 2                 # workers: the pods
FLIP_FRACTION = 1e-3  # ROADMAP C's flip rule for quantized rounds

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.launch.distributed import build_train_steps
from repro.models import init_params, lm_loss, reduced

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
arch = get_arch("llama4-scout-17b-a16e")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
assert arch.fsdp and arch.worker_axes == "pod"
cfg = arch.model
kw = dict(global_batch=8, seq_len=32, gamma=0.1, dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
toks = jax.random.randint(jax.random.PRNGKey(1), (2, 4, 32), 0, cfg.vocab_size)
first = {"toks": np.asarray(toks)}
first.update({f"p{i}": np.asarray(t) for i, t in enumerate(jax.tree.leaves(params))})
np.savez(sys.argv[1] + ".tmp.npz", **first)
os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1] + ".params.npz")

CASES = {"sync": {}, "randk": {}, "carry": dict(grad_carry=True),
         "qsgd": dict(compression="qsgd", qsgd_s=7, packed_payload=True),
         "pp": dict(grad_carry=True, participation=(1, "without"))}
CASES = {k: CASES[k] for k in sys.argv[2].split(",")}
out = {}
if "sync" in CASES:
    grads = jax.vmap(jax.grad(lambda p, t: lm_loss(p, cfg, t)), in_axes=(None, 0))(params, toks)
    out = {f"gref{i}": np.asarray(jnp.mean(t, 0)) for i, t in enumerate(jax.tree.leaves(grads))}
led = {}
for name, ckw in CASES.items():
    b = build_train_steps(arch, mesh, True, **kw, **ckw)
    fn, _ = b.fns["sync_step" if name == "sync" else "compressed_step"]
    if name == "sync":
        args = [params, jax.tree.map(jnp.zeros_like, params), {"tokens": toks}]
    else:
        args = [params, jax.tree.map(lambda t: jnp.full_like(t, 0.01), params)]
        if ckw.get("grad_carry"):
            args.append(jax.tree.map(lambda t: jnp.zeros((2, *t.shape), t.dtype), params))
        args += [{"tokens": toks}, jax.random.PRNGKey(2)]
        if "participation" in ckw:
            args.append(jnp.array([1], jnp.int32))
    with b.mesh:
        res = fn(*args)
    led[name] = sorted((k, float(v)) for k, v in b.transport.ledger.bits.items())
out["ledgers"] = np.array(repr(led))
np.savez(sys.argv[1], **out)
print("SUBPROCESS_OK", flush=True)
"""

_PORT_PROG = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")

import dataclasses
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.launch.distributed import build_train_steps
from repro_torch.models import init_params, moe, reduced
from repro_torch.models.layers import RowSplit

REF = np.load(os.environ["FSDP_REF"])
M = nproc // 4
mesh = topo.make_mesh((2, 2, M), ("pod", "data", "model"), device="cpu", fsdp=True)
assert (mesh.world, mesh.fsdp, mesh.model) == (2, 2, M)
tiers = topo.detect_topology(mesh)
assert tiers.tier_for_axes(("data",)) == "dcn" and tiers.n_processes == nproc
solo = topo.Mesh(axis_names=("pod", "data", "model"), sizes=(2, 2, M), device=torch.device("cpu"))
arch = get_arch("llama4-scout-17b-a16e")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
shapes = init_params(0, cfg, torch.float32, device="meta")
leaves, treedef = tree_flatten(shapes)
ref_tree = treedef.unflatten([REF[f"p{i}"] for i in range(len(leaves))])
params = params_from_jax(ref_tree, "cpu")
sliced = params_from_jax(ref_tree, "cpu", mesh=mesh, fsdp=True)
batch = {"tokens": torch.from_numpy(np.asarray(REF["toks"]))}
KW = dict(global_batch=8, seq_len=32, gamma=0.1, dtype=torch.float32)
CASES = {"sync": {}, "randk": {}, "carry": dict(grad_carry=True),
         "qsgd": dict(compression="qsgd", qsgd_s=7, packed_payload=True),
         "pp": dict(grad_carry=True, participation=(1, "without"))}
CASES = {k: CASES[k] for k in os.environ["FSDP_CASES"].split(",")}
if M > 1:
    CASES = {k: v for k, v in CASES.items() if k in ("sync", "randk")}


def run(m, name, ckw, a=arch, lp=None):
    b = build_train_steps(a, m, True, **KW, **ckw)
    lp = lp if lp is not None else (sliced if m is mesh else params)
    if name == "sync":
        args = [lp, tree_map(torch.zeros_like, lp), batch]
    else:
        args = [lp, tree_map(lambda t: torch.full_like(t, 0.01), lp)]
        if ckw.get("grad_carry"):
            args.append(tree_map(lambda t: t.new_zeros((len(m.workers(N := 2)), *t.shape)), lp))
        args += [batch, prng.PRNGKey(2)]
        if "participation" in ckw:
            args.append(torch.tensor([1], dtype=torch.int32))
    before = dict(m.payload_bytes)
    out = b.fns["sync_step" if name == "sync" else "compressed_step"](*args)
    wire = {k: v - before.get(k, 0) for k, v in m.payload_bytes.items()
            if v != before.get(k, 0)}
    state = [shd.gather_tree(t, m, shapes, True) for t in out[:2]]
    return state, wire, sorted(b.transport.ledger.bits.items()), b


def lm(got, want):
    worst, off, total = 0.0, 0, 0
    for a, c in zip(got, want):
        scale = float(c.abs().max()) or 1.0
        err = (a - c).abs() / scale
        off += int((err > 1e-4).sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
    return [worst, off, total]


res = {"rank": pid, "wire": {}, "ledger": {}, "lm": {}}
# 5. a rank's parameter bytes are its shards'
want = 0
for t, (fd, md) in zip(leaves, shd.leaf_splits(shapes, mesh, True)):
    want += t.numel() * 4 // (2 if fd is not None else 1) // (M if md is not None else 1)
res["bytes"] = [sum(t.numel() * t.element_size() for t in tree_leaves(sliced)), want]
dump = {}
for name, ckw in CASES.items():
    (x, g), wire, led, b = run(mesh, name, ckw)
    res["wire"][name] = wire
    res["ledger"][name] = [[list(k), v] for k, v in led]
    if name == "pp":
        res["pp_meta"] = [b.meta["flat_pp"], b.meta["cohort_compute"]]
    if pid:
        continue
    (xs, gs), _w, _l, _b = run(solo, name, ckw)
    res["lm"][name] = lm(tree_leaves(x) + tree_leaves(g), tree_leaves(xs) + tree_leaves(gs))
    if name == "sync":
        for i, t in enumerate(tree_leaves(g)):
            dump[f"sync_g{i}"] = t.numpy()

if M == 1 and os.environ.get("FSDP_MOE"):
    # the MoE capacity trap: capacity factor 0.5, pairs drop
    lo = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(7)
    p = moe.init_moe(gen, lo, torch.float32, "cpu")
    X = torch.randn((4, 32, 64), generator=gen)
    j = mesh.fsdp_rank
    p_loc = {k: v.detach().requires_grad_(True) for k, v in p.items() if k != "shared"}
    p_loc["shared"] = p["shared"]
    moe.moe_ff.drops = torch.zeros((), dtype=torch.int64)
    y, aux = moe.moe_ff(p_loc, lo, X[2 * j:2 * j + 2], RowSplit(mesh))
    drops = int(mesh.fsdp_sum(moe.moe_ff.drops[None])[0])
    (g_router,) = torch.autograd.grad(aux, [p_loc["router"]])
    g_router = mesh.fsdp_sum(g_router)
    p_one = {k: v.detach().requires_grad_(True) for k, v in p.items() if k != "shared"}
    p_one["shared"] = p["shared"]
    moe.moe_ff.drops = torch.zeros((), dtype=torch.int64)
    y1, aux1 = moe.moe_ff(p_one, lo, X)
    drops1 = int(moe.moe_ff.drops)
    moe.moe_ff.drops = None
    (g1,) = torch.autograd.grad(aux1, [p_one["router"]])
    res["moe"] = {
        "y": float((y - y1[2 * j:2 * j + 2]).abs().max() / y1.abs().max()),
        "aux": [float(aux), float(aux1)],
        "drops": [drops, drops1],
        "grad": float((g_router - g1).abs().max() / g1.abs().max()),
        "C": moe.capacity(lo.moe, 4 * 32), "T_local": 2 * 32}
    arch_lo = dataclasses.replace(arch, model=lo)
    (x, g), _w, _l, _b = run(mesh, "sync", {}, arch_lo)
    if pid == 0:
        (xs, gs), _w, _l, _b = run(solo, "sync", {}, arch_lo)
        res["lm"]["sync_cap0.5"] = lm(tree_leaves(g), tree_leaves(gs))
if pid == 0:
    np.savez(os.environ["FSDP_OUT"], **dump)
print("RES " + json.dumps(res), flush=True)
topo.shutdown()
"""


def _cluster(nproc: int, ref: str, out: str, cases: str, moe: bool) -> list:
    res = spawn_local_cluster(_PORT_PROG, num_processes=nproc, devices_per_process=1,
                              timeout=420.0,
                              extra_env={"FSDP_REF": ref, "FSDP_OUT": out, "FSDP_CASES": cases,
                                         "FSDP_MOE": "1" if moe else "",
                                         "OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(line[4:]) for r in res for line in r.stdout.splitlines()
            if line.startswith("RES ")]


def _no_tier(ledger) -> list:
    return sorted(((k[0], k[1], k[3]), v) for k, v in ledger)


def _check(results: list, got, ref, nleaf: int, ledgers: dict, nproc: int) -> None:
    assert len(results) == nproc
    # 1. sync g against the reference's unsharded worker mean
    if "sync_g0" in got.files:
        for i in range(nleaf):
            np.testing.assert_allclose(got[f"sync_g{i}"], ref[f"gref{i}"], rtol=1e-5,
                                       atol=1e-6)
    lead = next(r for r in results if r["rank"] == 0)
    # 2. the LM rule against the one-rank port (QSGD: counted level flips)
    for name, (worst, off, total) in lead["lm"].items():
        if name == "qsgd":
            assert off <= FLIP_FRACTION * total, (name, worst, off, total)
        else:
            assert worst <= 1e-4, (name, worst)
    # 3. ledgers; 4. the wire; 5. parameter bytes
    for r in results:
        assert r["bytes"][0] == r["bytes"][1], r["bytes"]
        for name, have in r["ledger"].items():
            assert _no_tier(have) == _no_tier(ledgers[name]), (name, have, ledgers[name])
            assert {k[2] for k, _v in have} == {"dcn"}, (name, have)
    for name in lead["ledger"]:
        booked = sum(v for k, v in lead["ledger"][name] if k[1] == "up")
        moved = [r["wire"][name] for r in results]
        wire = sum(v for w in moved for k, v in w.items()
                   if not k.startswith(("model/", "fsdp/")) and k != "gather_state")
        assert any(k.startswith("fsdp/") for w in moved for k in w), name
        if name == "pp":
            assert wire == 0 and sum(w.get("gather_state", 0) for w in moved) > 0
            assert lead["pp_meta"] == [False, True], lead["pp_meta"]
        else:
            assert wire * 8 / N == booked, (name, wire * 8 / N, booked)


def run_against_reference(tmp_path, cases: tuple, nprocs: tuple, moe: bool) -> dict:
    """The reference's program on ``cases`` and the port's clusters of
    ``nprocs`` ranks at once, checked (module doc); the clusters' results."""
    ref_path = str(tmp_path / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    names = ",".join(cases)
    proc = subprocess.Popen([sys.executable, "-c", _REF_PROG, ref_path, names],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        params = ref_path + ".params.npz"
        deadline = time.monotonic() + 240
        while not os.path.exists(params):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "the reference never wrote its parameters"
            time.sleep(0.2)
        with concurrent.futures.ThreadPoolExecutor(len(nprocs)) as pool:
            runs = {n: pool.submit(_cluster, n, params, str(tmp_path / f"port{n}.npz"),
                                   names, moe and n == 4)
                    for n in nprocs}
            results = {n: f.result() for n, f in runs.items()}
        out, err = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "SUBPROCESS_OK" in out
    ref = np.load(ref_path)
    nleaf = len([k for k in np.load(params).files if k.startswith("p")])
    ledgers = {k: [[list(kk), v] for kk, v in vv]
               for k, vv in ast.literal_eval(str(ref["ledgers"])).items()}
    for nproc, res in results.items():
        _check(res, np.load(str(tmp_path / f"port{nproc}.npz")), ref, nleaf, ledgers, nproc)
    return results


def check_moe(results: list) -> None:
    """The MoE capacity trap on the 4-rank cluster (a data group of two)."""
    for r in results:
        m = r["moe"]
        assert m["drops"][0] == m["drops"][1] > 0, m
        assert m["C"] < m["T_local"] * 2, m     # the lowered C: pairs drop
        assert m["y"] <= 1e-6 and m["grad"] <= 1e-5, m
        np.testing.assert_allclose(m["aux"][0], m["aux"][1], rtol=1e-6)
    assert results[0]["lm"]["sync_cap0.5"][0] <= 1e-4
