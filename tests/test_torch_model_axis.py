"""The model axis across ranks: parameters sharded by the rule table
(``launch/sharding.py``), trained through the port's ``build_train_steps``
on gloo CPU clusters of 2 and 4 ranks, against the reference's own sharded
program.

The reference's program is ``tests/test_sharding.py``'s seven round types
on a reduced Qwen1.5-0.5B (2 layers, d_model 64) over a (4, 2) ("data",
"model") mesh of 8 fake devices, run here with Auto axes (ROADMAP C: JAX 0.9
needs them) in a subprocess that also writes its parameters, tokens, the
unsharded worker-mean gradient, each round's delta and each bundle's ledger.
As soon as its parameters are written, the port runs the same rounds from
them on two gloo clusters at once:

* 2 ranks: one worker group of all four workers, its two model ranks
  holding one slice each of every sharded leaf;
* 4 ranks: two worker groups of two workers, two model ranks each (both
  axes cross processes: "dcn" tiers).

Rank 0 of each also runs the one-rank port (a mesh with no group) on the
whole parameters. The assertions, per round type (sync; randk; permk;
packed QSGD s = 7; carry + QSGD downlink; PP (2, "without") with the carry;
trimmed_mean under ``nan`` faults):

1. the sync ``g`` is within rtol 1e-5 / atol 1e-6 of the reference's
   unsharded worker-mean gradient, and its error within the reference's
   own 2e-4;
2. every compressed round's params and g are within the LM rule (1e-4 of
   each leaf's scale) of the one-rank port; under QSGD a level may flip
   (ROADMAP C's rule: within one quantization step, at most 1e-3 of the
   coordinates), since the row-parallel sums change the gradient's last
   bits;
3. the nonzero-delta counts (|Δ| > 1e-12) equal the reference's, apart
   from the coordinates listed, each a QSGD level flip of the robust round
   (one quantization step) or within float noise of the threshold;
4. the ledgers are bit-equal to the reference's (by scope, direction and
   kind; the tier is the cluster's), and the bytes the wire's collectives
   carried, summed over every rank, ×8 ÷ n, equal the booked uplink in
   every round — the model-axis reshards count apart (``model/...``) — but
   the robust round's, whose decoded rows cross dense (ROADMAP C);
5. the PP carry refreshes exactly rows 1 and 3, and the PP bundle is on the
   per-leaf cohort path (``flat_pp`` False, ``cohort_compute`` True).
"""

import ast
import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.launch.topology import spawn_local_cluster

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASES = ("randk", "permk", "qsgd", "carry_down", "pp", "robust")
N = 4
#: ROADMAP C's flip rule for quantized rounds
FLIP_FRACTION = 1e-3

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.core import FaultSpec, ServerAggregator
from repro.launch.distributed import build_train_steps
from repro.models import init_params, lm_loss, reduced

assert jax.device_count() == 8
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
arch = get_arch("qwen1.5-0.5b")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
kw = dict(multi_pod=False, global_batch=8, seq_len=64, gamma=0.1, dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 2, 64), 0, cfg.vocab_size)
batch = {"tokens": toks}
# the inputs first, so the port can start on them
first = {"toks": np.asarray(toks)}
first.update({f"p{i}": np.asarray(t) for i, t in enumerate(jax.tree.leaves(params))})
np.savez(sys.argv[1] + ".tmp.npz", **first)
os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1] + ".params.npz")

grads = jax.vmap(jax.grad(lambda p, t: lm_loss(p, cfg, t)), in_axes=(None, 0))(params, toks)
g_ref = jax.tree.map(lambda t: jnp.mean(t, 0), grads)
out = {f"gref{i}": np.asarray(t) for i, t in enumerate(jax.tree.leaves(g_ref))}
b = build_train_steps(arch, mesh, **kw)
with b.mesh:
    fn, _ = b.fns["sync_step"]
    _, g_new = fn(jax.tree.map(jnp.array, params), jax.tree.map(jnp.zeros_like, params), batch)
out["sync_err"] = np.float64(max(float(jnp.max(jnp.abs(a - c)))
                                 for a, c in zip(jax.tree.leaves(g_new), jax.tree.leaves(g_ref))))
CASES = {
    "randk": dict(), "permk": dict(compression="permk"),
    "qsgd": dict(compression="qsgd", qsgd_s=7, packed_payload=True),
    "carry_down": dict(grad_carry=True, downlink="qsgd", downlink_s=7),
    "pp": dict(grad_carry=True, participation=(2, "without")),
    "robust": dict(compression="qsgd", qsgd_s=7, aggregator=ServerAggregator("trimmed_mean", f=1),
                   faults=FaultSpec("nan", frac=0.25)),
}
led = {}
for name, ckw in CASES.items():
    bb = b if name == "randk" else build_train_steps(arch, mesh, **kw, **ckw)
    if name == "pp":
        assert not bb.meta["flat_pp"] and bb.meta["cohort_compute"]
    args = [jax.tree.map(jnp.array, params), jax.tree.map(lambda t: jnp.full_like(t, 0.01), params)]
    if ckw.get("grad_carry"):
        args.append(jax.tree.map(lambda t: jnp.zeros((4, *t.shape), t.dtype), params))
    args += [batch, jax.random.PRNGKey(2)]
    if "participation" in ckw:
        args.append(jnp.array([1, 3], jnp.int32))
    with bb.mesh:
        fn, _ = bb.fns["compressed_step"]
        res = fn(*args)
    for i, t in enumerate(jax.tree.leaves(res[1])):
        out[f"{name}_d{i}"] = np.asarray(t) - np.float32(0.01)
    led[name] = sorted((k, float(v)) for k, v in bb.transport.ledger.bits.items())
out["ledgers"] = np.array(repr(led))
np.savez(sys.argv[1], **out)
print("SUBPROCESS_OK", float(out["sync_err"]), flush=True)
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
from repro_torch.core import FaultSpec, ServerAggregator
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map
from repro_torch.launch import sharding as shd
from repro_torch.launch.distributed import build_train_steps
from repro_torch.models import init_params, reduced

REF = np.load(os.environ["MODEL_AXIS_REF"])
N = 4
mesh = topo.make_test_mesh(N, 2, device="cpu")
assert mesh.model == 2 and mesh.world == nproc // 2, (mesh.model, mesh.world)
tiers = topo.detect_topology(mesh)
assert tiers.tier_for_axes(("model",)) == "dcn" and tiers.n_processes == nproc
solo = topo.Mesh(axis_names=("data", "model"), sizes=(N, 2), device=torch.device("cpu"))
arch = get_arch("qwen1.5-0.5b")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model
shapes = init_params(0, cfg, torch.float32, device="meta")
leaves, treedef = tree_flatten(shapes)
# the reference's weights, whole (the one-rank run) and this rank's slices
ref_tree = treedef.unflatten([REF[f"p{i}"] for i in range(len(leaves))])
params = params_from_jax(ref_tree, "cpu")
sliced = params_from_jax(ref_tree, "cpu", mesh=mesh)
batch = {"tokens": torch.from_numpy(np.asarray(REF["toks"]))}
KW = dict(global_batch=8, seq_len=64, gamma=0.1, dtype=torch.float32)
CASES = {
    "randk": dict(), "permk": dict(compression="permk"),
    "qsgd": dict(compression="qsgd", qsgd_s=7, packed_payload=True),
    "carry_down": dict(grad_carry=True, downlink="qsgd", downlink_s=7),
    "pp": dict(grad_carry=True, participation=(2, "without")),
    "robust": dict(compression="qsgd", qsgd_s=7,
                   aggregator=ServerAggregator("trimmed_mean", f=1),
                   faults=FaultSpec("nan", frac=0.25)),
}


def run(m, name, ckw):
    b = build_train_steps(arch, m, False, **KW, **ckw)
    lp = sliced if m is mesh else params
    if name == "sync":
        args = [lp, tree_map(torch.zeros_like, lp), batch]
    else:
        args = [lp, tree_map(lambda t: torch.full_like(t, 0.01), lp)]
        if ckw.get("grad_carry"):
            args.append(tree_map(lambda t: t.new_zeros((len(m.workers(N)), *t.shape)), lp))
        args += [batch, prng.PRNGKey(2)]
        if "participation" in ckw:
            args.append(torch.tensor([1, 3], dtype=torch.int32))
    before = dict(m.payload_bytes)
    out = b.fns["sync_step" if name == "sync" else "compressed_step"](*args)
    wire = {k: v - before.get(k, 0) for k, v in m.payload_bytes.items()
            if v != before.get(k, 0)}
    state = [shd.gather_tree(t, m, shapes) for t in out[:2]]
    h = [m.gather_rows(t, N) for t in tree_leaves(out[2])] if len(out) == 3 else None
    return state, h, wire, sorted(b.transport.ledger.bits.items()), b


res = {"rank": pid, "wire": {}, "ledger": {}, "lm": {}}
dump = {}
for name, ckw in [("sync", {})] + list(CASES.items()):
    (x, g), h, wire, led, b = run(mesh, name, ckw)
    res["wire"][name] = wire
    res["ledger"][name] = [[list(k), v] for k, v in led]
    if name == "pp":
        res["pp_meta"] = [b.meta["flat_pp"], b.meta["cohort_compute"]]
    if h is not None:
        # the carry rows this rank's slice refreshed
        res.setdefault("hrows", {})[name] = [
            [bool(t[r].abs().max() > 0) for r in range(N)] for t in h]
    if pid:
        continue
    (xs, gs), _h, _w, _l, _b = run(solo, name, ckw)
    worst, off, total = 0.0, 0, 0
    for a, c in zip(tree_leaves(x) + tree_leaves(g), tree_leaves(xs) + tree_leaves(gs)):
        scale = float(c.abs().max()) or 1.0
        err = (a - c).abs() / scale
        off += int((err > 1e-4).sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
    res["lm"][name] = [worst, off, total]
    for i, t in enumerate(tree_leaves(g)):
        dump[f"{name}_g{i}"] = t.numpy()
if pid == 0:
    np.savez(os.environ["MODEL_AXIS_OUT"], **dump)
print("RES " + json.dumps(res), flush=True)
topo.shutdown()
"""


def _cluster(nproc: int, ref: str, out: str) -> list:
    res = spawn_local_cluster(_PORT_PROG, num_processes=nproc, devices_per_process=1,
                              timeout=420.0,
                              extra_env={"MODEL_AXIS_REF": ref, "MODEL_AXIS_OUT": out,
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
    for i in range(nleaf):
        np.testing.assert_allclose(got[f"sync_g{i}"], ref[f"gref{i}"], rtol=1e-5, atol=1e-6)
    err = max(float(np.abs(got[f"sync_g{i}"] - ref[f"gref{i}"]).max()) for i in range(nleaf))
    assert err < 2e-4 and float(ref["sync_err"]) < 2e-4, (err, float(ref["sync_err"]))
    lead = next(r for r in results if r["rank"] == 0)
    # 2. the LM rule against the one-rank port (QSGD: counted level flips)
    for name, (worst, off, total) in lead["lm"].items():
        if name in ("qsgd", "robust"):
            assert off <= FLIP_FRACTION * total, (name, worst, off, total)
        else:
            assert worst <= 1e-4, (name, worst)
    # 3. nonzero-delta counts against the reference's
    for name in CASES:
        listed = []
        for i in range(nleaf):
            want = ref[f"{name}_d{i}"]
            have = got[f"{name}_g{i}"] - np.float32(0.01)
            for j in np.argwhere((np.abs(want) > 1e-12) != (np.abs(have) > 1e-12)):
                j = tuple(j)
                listed.append((i, j, float(want[j]), float(have[j])))
        noise = [c for c in listed if max(abs(c[2]), abs(c[3])) < 1e-9]
        flips = [c for c in listed if c not in noise]
        assert not flips or name == "robust", (name, flips)
        assert len(flips) <= FLIP_FRACTION * sum(got[f"{name}_g{i}"].size
                                                 for i in range(nleaf)), (name, flips)
        for i, j, _w, h in flips:
            # one quantization step: a level of the worker's row norm / s / n
            assert abs(h) < 1e-2, (name, i, j, h)
    # 4. ledgers and the wire
    tier = "dcn" if nproc > 2 else "loopback"
    for r in results:
        full = dict(r["ledger"])
        for name in CASES:
            want = ledgers[name]
            have = full[name] + (full["sync"] if name == "randk" else [])
            assert _no_tier(have) == _no_tier(want), (name, have, want)
            assert {k[2] for k, _v in have} == {tier}, (name, have)
    for name in ("sync",) + CASES:
        booked = sum(v for k, v in dict(lead["ledger"])[name] if k[1] == "up")
        wire = sum(v for r in results for k, v in r["wire"][name].items()
                   if not k.startswith("model/") and k != "gather_state")
        if name == "robust":
            assert wire == 0, (name, wire)   # decoded rows cross dense (gather_state)
        else:
            assert wire * 8 / N == booked, (name, wire * 8 / N, booked)
    # 5. PP: the per-leaf cohort path, exactly rows 1 and 3 refreshed
    for r in results:
        assert r["pp_meta"] == [False, True]
        for rows in r["hrows"]["pp"]:
            assert rows == [False, True, False, True], rows


def test_sharded_rounds_match_reference_and_one_rank(tmp_path):
    ref_path = str(tmp_path / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.Popen([sys.executable, "-c", _REF_PROG, ref_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        params = ref_path + ".params.npz"
        deadline = time.monotonic() + 240
        while not os.path.exists(params):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "the reference never wrote its parameters"
            time.sleep(0.2)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {n: pool.submit(_cluster, n, params, str(tmp_path / f"port{n}.npz"))
                    for n in (2, 4)}
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
    ledgers = {k: [(tuple(kk), v) for kk, v in vv]
               for k, vv in ast.literal_eval(str(ref["ledgers"])).items()}
    for nproc, results in results.items():
        got = np.load(str(tmp_path / f"port{nproc}.npz"))
        _check(results, got, ref, nleaf, {k: [[list(kk), v] for kk, v in vv]
                                          for k, vv in ledgers.items()}, nproc)
