"""The port's launch layer across processes: a gloo cluster on the CPU.

The worker program below is one program run two ways through the same
bring-up (``topology.spawn_local_cluster`` → ``init_from_env`` →
``torch.distributed.init_process_group`` over gloo):

* 2 processes × 2 workers — the worker ("data") axis crosses the process
  boundary, so every payload collective leaves the process (the local
  cluster's dcn tier);
* 1 process × 4 workers — one process hosting the whole fleet (loopback).

Both run a sync round and three compressed grad-carry MARINA rounds (randk)
on the same reduced Qwen1.5-0.5B and data, and print the trajectory, a
digest of every byte of the final state, the booked bits and their tiers;
then flat PP-MARINA rounds with the server's carry table and without it
(each cohort row forms on the rank that holds its group, and with the
carry on the rank that owns its h row) and a robust trimmed-mean QSGD
round under a mean-shift attack (which reads the whole fleet's rows).
The assertions, as ``tests/test_multiproc.py``'s for the reference:

1. the ranks of the 2-process run agree exactly;
2. the trajectories agree BIT FOR BIT across the layouts: each rank stages
   its own workers' rows, the payloads cross by all-gather (the sync rows by
   an all-reduce of disjoint rows, which adds only zeros), and the mean runs
   in worker order 0..n−1 on every rank (tighter than the reference's
   rtol 1e-5, whose gloo all-reduce reorders the sum);
3. the same bits are booked, under "dcn" across processes and "loopback"
   in one, and the bytes the collectives carried, summed over the ranks,
   ×8 ÷ n, are the booked bits of each round — a flat-PP round's too, with
   no dense state (``gather_state``) crossing for the test's cohorts.

The crash twin: rank 1 hard-exits at the top of round 3; the resilient
runner kills the hung survivor, and the recovery relaunch (one process, the
dead rank's clients as a static ``drop`` set from round 3) matches a plain
single-process run with that drop set, while the drop rounds book half the
fault-free uplink.
"""

import re

import numpy as np
import pytest

from repro_torch.launch import topology as topo
from repro_torch.launch.topology import run_with_recovery, spawn_local_cluster
from repro_torch.launch.transport import RetryPolicy

RETRY = RetryPolicy(timeout_s=240.0, retries=2, backoff_s=1.0)

_SETUP = r"""
import hashlib, os
import torch
torch.set_num_threads(1)
from repro_torch.launch import topology as topo
pid, nproc = topo.init_from_env(device="cpu")

import dataclasses
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import FaultSpec
from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.launch.distributed import build_train_steps
from repro_torch.models import init_params, reduced

N = 4
mesh = topo.make_test_mesh(N, 1, device="cpu")
assert mesh.world == nproc and len(mesh.workers(N)) == topo.local_workers()
t = topo.detect_topology(mesh)
expect = "dcn" if nproc > 1 else "loopback"
assert t.tier_for_axes(("data",)) == expect, (t.axis_tiers, nproc)
assert t.n_processes == nproc

arch = get_arch("qwen1.5-0.5b")
arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
cfg = arch.model


def bundle(faults=None):
    return build_train_steps(arch, mesh, False, global_batch=2 * N, seq_len=32, gamma=0.1,
                             dtype=torch.float32, grad_carry=True, faults=faults)


params = init_params(0, cfg, torch.float32, device="cpu")
rows = mesh.workers(N)
g0 = tree_map(torch.zeros_like, params)
h0 = tree_map(lambda p: torch.zeros((len(rows), *p.shape)), params)
toks = torch.randint(0, cfg.vocab_size, (N, 2, 32), generator=torch.Generator().manual_seed(1))
batch = {"tokens": toks}


def checksum(tree):
    return float(sum(float(leaf.double().sum()) for leaf in tree_leaves(tree)))


# the bytes of this rank's rows the mesh's collectives carried since
# ``before`` (a copy of ``mesh.payload_bytes``), by kind
def wire_since(before):
    return {k: v - before.get(k, 0) for k, v in mesh.payload_bytes.items()
            if v != before.get(k, 0)}


def digest(*trees):
    h = hashlib.sha256()
    for tree in trees:
        for leaf in tree_leaves(tree):
            h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()
"""

_WORKER_PROG = _SETUP + r"""
b = bundle()
fs, fc = b.fns["sync_step"], b.fns["compressed_step"]
before = dict(mesh.payload_bytes)
x, g, h = fs(params, g0, h0, batch)
wire = [wire_since(before)]
traj = [checksum(x), checksum(g)]
for i in range(3):
    before = dict(mesh.payload_bytes)
    x, g, h = fc(x, g, h, batch, prng.PRNGKey(10 + i))
    wire.append(wire_since(before))
    traj += [checksum(x), checksum(g)]
led = b.transport.ledger
print("WIRE", wire)
print("UPCOMP", repr(led.total_bits(scope="compressed_step", direction="up")))
print("PADDED", b.transport.sync_layout.padded)
up_tiers = sorted({tier for (_s, d, tier, _k) in led.bits if d == "up"})
assert up_tiers == [expect], (up_tiers, expect)
print("TIERS", ",".join(up_tiers))
print("UPBITS", repr(led.total_bits(direction="up")))
print("TRAJ", " ".join(repr(v) for v in traj))
print("STATE", digest(x, g))
print("COLLECTIVES", sorted(mesh.collectives.items()))

# PP-MARINA with the server carry table (flat PP, cohort compute: shard
# gradients assembled across ranks), and a robust QSGD round under a
# fleet-wide attack (the decoded rows and the attacked diffs assembled)
from repro_torch.core import ServerAggregator
pp = build_train_steps(arch, mesh, False, global_batch=2 * N, seq_len=32, gamma=0.1,
                       dtype=torch.float32, grad_carry=True, participation=(2, "without"))
assert pp.meta["cohort_compute"] and pp.meta["flat_pp"]
x, g, h = pp.fns["sync_step"](params, g0, h0, batch)
wire_pp = []
for i, sel in enumerate(([1, 3], [2, 0])):
    before = dict(mesh.payload_bytes)
    x, g, h = pp.fns["compressed_step"](x, g, h, batch, prng.PRNGKey(20 + i), sel)
    wire_pp.append(wire_since(before))
print("PP", digest(x, g, tree_map(lambda t: mesh.gather_rows(t, N), h)))
print("WIREPP", wire_pp)
print("UPPP", repr(pp.transport.ledger.total_bits(scope="compressed_step", direction="up")))
# the recompute shape (no carry table): both gradients of each cohort row
# form where the row's group lies
ppr = build_train_steps(arch, mesh, False, global_batch=2 * N, seq_len=32, gamma=0.1,
                        dtype=torch.float32, participation=(2, "without"))
assert ppr.meta["cohort_compute"] and ppr.meta["flat_pp"]
x, g = ppr.fns["sync_step"](params, g0, batch)
wire_ppr = []
for i, sel in enumerate(([1, 3], [2, 0])):
    before = dict(mesh.payload_bytes)
    x, g = ppr.fns["compressed_step"](x, g, batch, prng.PRNGKey(40 + i), sel)
    wire_ppr.append(wire_since(before))
print("PPR", digest(x, g))
print("WIREPPR", wire_ppr)
print("UPPPR", repr(ppr.transport.ledger.total_bits(scope="compressed_step", direction="up")))
# cohorts spread unevenly over the ranks: [1, 0] and [3, 2] (a client's
# gradient forms off its h row's rank and moves there), then r = 1 (the one
# group spans both ranks: its partial sum moves on; for client 0 the row
# then moves to its owner too)
wire_ppu = []
batch4 = {"tokens": torch.randint(0, cfg.vocab_size, (N, 4, 32),
                                  generator=torch.Generator().manual_seed(2))}
for r_u, sels, bt in ((2, ([1, 0], [3, 2]), batch), (1, ([2], [0]), batch4)):
    ppu = build_train_steps(arch, mesh, False, global_batch=N * bt["tokens"].shape[1],
                            seq_len=32, gamma=0.1, dtype=torch.float32, grad_carry=True,
                            participation=(r_u, "without"))
    assert ppu.meta["cohort_compute"]
    x, g, h = ppu.fns["sync_step"](params, g0, h0, bt)
    for i, sel in enumerate(sels):
        before = dict(mesh.payload_bytes)
        x, g, h = ppu.fns["compressed_step"](x, g, h, bt, prng.PRNGKey(50 + i), sel)
        wire_ppu.append(wire_since(before))
    print(f"PPU{r_u}", digest(x, g, tree_map(lambda t: mesh.gather_rows(t, N), h)))
    print(f"UPPPU{r_u}", repr(ppu.transport.ledger.total_bits(scope="compressed_step",
                                                              direction="up")))
print("WIREPPU", wire_ppu)
print("D", sum(t.numel() for t in tree_leaves(params)))
rb = build_train_steps(arch, mesh, False, global_batch=2 * N, seq_len=32, gamma=0.1,
                       dtype=torch.float32, compression="qsgd", qsgd_s=7,
                       packed_payload=True, aggregator=ServerAggregator("trimmed_mean", f=1),
                       faults=FaultSpec("mean_shift", frac=0.25, scale=3.0))
x, g = rb.fns["compressed_step"](params, g0, batch, prng.PRNGKey(30))
print("ROBUST", digest(x, g))
topo.shutdown()
"""

_CRASH_PROG = _SETUP + r"""
dead, resume = topo.recovery_from_env()
rounds = int(os.environ.get("MARINA_MP_ROUNDS", "6"))
b = bundle()
faulted = bundle(FaultSpec("drop", ids=dead)) if dead else None
fs, fc = b.fns["sync_step"], b.fns["compressed_step"]
fcd = faulted.fns["compressed_step"] if faulted else None
x, g, h = fs(params, g0, h0, batch)
print(f"TRAJ0 {checksum(x)!r} {checksum(g)!r}")
print(f"{topo.HEARTBEAT} 0", flush=True)
for k in range(1, rounds):
    topo.maybe_crash(pid, k)
    step = fcd if (fcd is not None and k >= resume) else fc
    x, g, h = step(x, g, h, batch, prng.PRNGKey(10 + k))
    print(f"TRAJ{k} {checksum(x)!r} {checksum(g)!r}")
    print(f"{topo.HEARTBEAT} {k}", flush=True)
print("UPFREE", repr(b.transport.ledger.total_bits(scope="compressed_step", direction="up")))
if faulted is not None:
    print("UPDROP", repr(faulted.transport.ledger.total_bits(scope="compressed_step",
                                                             direction="up")))
print("DONE", flush=True)
topo.shutdown()
"""

ENV = {"OMP_NUM_THREADS": "1"}


def _parse(stdout: str, tag: str) -> str:
    m = re.search(rf"^{tag} (.+)$", stdout, re.M)
    assert m, f"no {tag} line in:\n{stdout[-2000:]}"
    return m.group(1)


def _run(num_processes: int, devices_per_process: int, prog: str = _WORKER_PROG,
         extra_env: dict = None):
    results = spawn_local_cluster(prog, num_processes=num_processes,
                                  devices_per_process=devices_per_process,
                                  extra_env={**ENV, **(extra_env or {})}, retry=RETRY)
    for r in results:
        assert r.returncode == 0, f"rank failed ({num_processes}p):\n{r.stderr[-4000:]}"
    return results


def test_two_process_compressed_carry_equals_single_process():
    mp = _run(2, 2)
    sp = _run(1, 4)
    for tag in ("TRAJ", "STATE", "UPBITS", "PP", "PPR", "PPU2", "PPU1", "ROBUST"):
        assert _parse(mp[0].stdout, tag) == _parse(mp[1].stdout, tag), tag
    traj_mp = np.array([float(v) for v in _parse(mp[0].stdout, "TRAJ").split()])
    assert traj_mp.shape == (8,) and np.all(np.isfinite(traj_mp))
    # bit for bit: the state's every byte, not only the checksums
    assert _parse(mp[0].stdout, "TRAJ") == _parse(sp[0].stdout, "TRAJ")
    assert _parse(mp[0].stdout, "STATE") == _parse(sp[0].stdout, "STATE")
    # PP with the carry table and without it, and a robust round under a
    # fleet-wide attack, bit for bit across the layouts too
    assert _parse(mp[0].stdout, "PP") == _parse(sp[0].stdout, "PP")
    assert _parse(mp[0].stdout, "PPR") == _parse(sp[0].stdout, "PPR")
    assert _parse(mp[0].stdout, "PPU2") == _parse(sp[0].stdout, "PPU2")
    assert _parse(mp[0].stdout, "PPU1") == _parse(sp[0].stdout, "PPU1")
    assert _parse(mp[0].stdout, "ROBUST") == _parse(sp[0].stdout, "ROBUST")
    assert _parse(mp[0].stdout, "TIERS") == "dcn"
    assert _parse(sp[0].stdout, "TIERS") == "loopback"
    assert float(_parse(mp[0].stdout, "UPBITS")) == float(_parse(sp[0].stdout, "UPBITS"))
    # the payloads crossed the group: 2 gathers a leaf a compressed round
    # (values, offsets), one all-reduce a sync round (the packed buffer)
    coll = dict(eval(_parse(mp[0].stdout, "COLLECTIVES")))
    assert coll == {"all_gather": 3 * 2 * 14, "all_reduce": 1}
    # the bytes the collectives carried, summed over the ranks, ×8 ÷ n: the
    # booked uplink of each compressed round, and 32 bits a padded slot of
    # the flat buffer on the sync round, in both layouts
    up_comp = float(_parse(sp[0].stdout, "UPCOMP"))
    padded = int(_parse(sp[0].stdout, "PADDED"))
    for run in (mp, sp):
        wires = [eval(_parse(r.stdout, "WIRE")) for r in run]
        for k in range(4):
            kinds = {kind for w in wires for kind in w[k]}
            bits = sum(sum(w[k].values()) for w in wires) * 8.0 / 4
            if k == 0:
                assert kinds == {"all_reduce"} and bits == 32.0 * padded, (len(run), k)
            else:
                assert kinds == {"all_gather"} and bits == up_comp, (len(run), k, bits)
    # a compressed flat-PP round puts on the wire only what it books: the r
    # cohort rows' payloads and seeds, all-gathered (bytes summed over the
    # ranks, x8 / n, are the booked r·ζ/n), and no dense state: cohorts
    # [1, 3] and [2, 0] each put one client on each rank's h rows
    for tag, up_tag in (("WIREPP", "UPPP"), ("WIREPPR", "UPPPR")):
        up_pp = float(_parse(sp[0].stdout, up_tag))
        assert up_pp > 0 and float(_parse(mp[0].stdout, up_tag)) == up_pp
        for run in (mp, sp):
            wires = [eval(_parse(r.stdout, tag)) for r in run]
            for k in range(2):
                kinds = {kind for w in wires for kind in w[k]}
                assert kinds == {"all_gather"}, (tag, len(run), k, kinds)
                assert sum(w[k].get("gather_state", 0) for w in wires) == 0
                bits = sum(sum(w[k].values()) for w in wires) * 8.0 / 4
                assert bits == up_pp, (tag, len(run), k, bits, up_pp)
    # uneven cohorts: the payloads still carry exactly the booked bits; the
    # dense rows that cross are counted apart, 4·d bytes each (one moved
    # gradient for [1, 0], [3, 2] and [2]; a partial sum and a moved
    # gradient for [0] at r = 1); one process moves none
    d = int(_parse(sp[0].stdout, "D"))
    ups = [float(_parse(sp[0].stdout, t)) for t in ("UPPPU2",) * 2 + ("UPPPU1",) * 2]
    for run, dense in ((mp, [1, 1, 1, 2]), (sp, [0, 0, 0, 0])):
        wires = [eval(_parse(r.stdout, "WIREPPU")) for r in run]
        for k in range(4):
            state = sum(w[k].get("gather_state", 0) for w in wires)
            assert state == dense[k] * 4 * d, (len(run), k, state)
            bits = sum(w[k].get("all_gather", 0) for w in wires) * 8.0 / 4
            assert bits == ups[k], (len(run), k, bits, ups[k])


def _traj(stdout: str, k: int) -> str:
    return _parse(stdout, f"TRAJ{k}")


def test_crash_recovery_matches_single_process_drop():
    crash_round, rounds = 3, 6
    outcome, rec = run_with_recovery(
        _CRASH_PROG, num_processes=2, devices_per_process=2,
        extra_env={**ENV, topo.CRASH_ENV: f"1@{crash_round}", "MARINA_MP_ROUNDS": str(rounds)},
        retry=RETRY, timeout=240.0)
    assert outcome.crashed
    assert outcome.dead_ranks == (1,), [(r.returncode, r.stderr[-500:])
                                        for r in outcome.results]
    assert outcome.last_round == crash_round - 1
    assert rec is not None and rec.returncode == 0, rec.stderr[-4000:]
    ref = _run(1, 4, _CRASH_PROG, {topo.DEAD_ENV: "2,3", topo.RESUME_ENV: str(crash_round),
                                   "MARINA_MP_ROUNDS": str(rounds)})[0]
    for k in range(rounds):
        assert _traj(rec.stdout, k) == _traj(ref.stdout, k), k
    # the replayed prefix reproduces what the 2-process fleet computed
    for k in range(crash_round):
        assert _traj(outcome.results[0].stdout, k) == _traj(rec.stdout, k), k
    up_free = float(_parse(rec.stdout, "UPFREE"))
    up_drop = float(_parse(rec.stdout, "UPDROP"))
    assert up_free > 0
    assert up_drop == pytest.approx(up_free * 0.5)
