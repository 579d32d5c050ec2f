"""The port's topology layer against the reference's pure functions.

* The link table, the production fabrics' tiers, group-size and
  member-id tiers, the worker axes, the worker count and the cohort group
  size: equal to ``repro.launch.topology``'s on the same inputs
  (``tests/test_topology.py``'s cases, run through both packages).
* ``detect_topology`` on one process: every axis loopback on the CPU; the
  GPU rule (an axis whose workers span processes is ``ici`` under nccl,
  ``dcn`` under gloo; workers inside one process ``loopback``) on meshes
  laid over 2 and 4 ranks.
* The mesh: its contiguous worker groups, and its row exchanges without a
  group and on a one-rank gloo group (all-gather as bytes, so bf16, int16
  and int8 payloads cross; all-reduce of disjoint rows), counted.
* The crash / recovery environment helpers, as the reference's.
"""

import dataclasses

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.core.wire import LINK_TIERS as J_LINK_TIERS
from repro.launch import topology as jtopo
from repro_torch.core.wire import LINK_TIERS
from repro_torch.launch import topology as topo


class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes


def test_link_table_matches_the_reference():
    assert topo.TIERS == jtopo.TIERS == LINK_TIERS == J_LINK_TIERS
    assert {k: dataclasses.astuple(v) for k, v in topo.DEFAULT_LINKS.items()} == {
        k: dataclasses.astuple(v) for k, v in jtopo.DEFAULT_LINKS.items()}
    for env in ("PROCESS_ENV", "COORD_ENV", "CRASH_ENV", "DEAD_ENV", "RESUME_ENV",
                "HEARTBEAT"):
        assert getattr(topo, env) == getattr(jtopo, env)


def _same(t, j):
    return (t.axis_tiers, t.n_devices, t.n_processes, t.devices_per_pod) == (
        j.axis_tiers, j.n_devices, j.n_processes, j.devices_per_pod)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_tiers_match_the_reference(multi_pod):
    t = topo.production_topology(multi_pod=multi_pod)
    j = jtopo.production_topology(multi_pod=multi_pod)
    assert _same(t, j)
    axes = [("pod",), ("data",), ("model",), ("pod", "data"), ("data", "model"), (), "data"]
    for a in axes:
        if multi_pod or "pod" not in a:
            assert t.tier_for_axes(a) == j.tier_for_axes(a)
    for g in (1, 2, 16, 255, 256, 257, 512):
        assert t.tier_for_group_size(g) == j.tier_for_group_size(g)
    for ids in ([7], range(16), list(range(0, 512, 16)), [0, 255], [255, 256]):
        assert t.tier_for_ids(ids) == j.tier_for_ids(ids)
    for tier in topo.TIERS:
        assert dataclasses.astuple(t.link(tier)) == dataclasses.astuple(j.link(tier))


def test_local_cluster_tiers_match_the_reference():
    for tiers, nproc in ((((("data", "dcn"), ("model", "loopback"))), 2),
                         ((("data", "loopback"), ("model", "loopback")), 1)):
        t = topo.Topology(axis_tiers=tiers, n_devices=4, n_processes=nproc)
        j = jtopo.Topology(axis_tiers=tiers, n_devices=4, n_processes=nproc)
        assert t.devices_per_process == j.devices_per_process
        for g in (1, 2, 3, 4):
            assert t.tier_for_group_size(g) == j.tier_for_group_size(g)
        for ids in ([0, 2], [0, 1], [3], [0, 1, 2, 3]):
            assert t.tier_for_ids(ids) == j.tier_for_ids(ids)


def test_worker_axes_and_counts_match_the_reference():
    for mp in (False, True):
        for wa in ("data", "pod", "pod_data"):
            assert topo.worker_axis_names(mp, wa) == jtopo.worker_axis_names(mp, wa)
    for mesh, mp, wa in ((FakeMesh(data=16, model=16), False, "data"),
                         (FakeMesh(pod=2, data=16, model=16), True, "pod"),
                         (FakeMesh(pod=2, data=16, model=16), True, "pod_data")):
        assert topo.num_workers(mesh, mp, wa) == jtopo.num_workers(mesh, mp, wa)
    for n, r in ((8, 2), (8, 8), (8, 3), (8, 0), (4, 2), (6, 4)):
        assert topo.cohort_group_size(n, r) == jtopo.cohort_group_size(n, r)


def test_detect_topology_one_process():
    mesh = topo.make_test_mesh(1, 1, device="cpu")
    t = topo.detect_topology(mesh)
    assert t.n_devices == 1 and t.n_processes == 1 and t.devices_per_pod is None
    assert t.tier_for_axes(("data", "model")) == "loopback"
    assert t.tier_for_group_size(1) == "loopback"
    m4 = topo.make_test_mesh(4, 1, device="cpu")
    assert topo.detect_topology(m4).tier_for_axes(("data",)) == "loopback"


@pytest.mark.parametrize("dev,span", [("cpu", "dcn"), ("cuda", "ici")])
def test_detect_topology_tier_rule(dev, span):
    """Workers spanning ranks: dcn under gloo (CPU), ici under nccl (GPU);
    inside one rank: loopback on either; pod: always dcn; the model axis
    never leaves a rank."""
    def laid(shape, axes, rank, world):
        return topo.Mesh(axis_names=axes, sizes=shape, device=torch.device(dev),
                         rank=rank, world=world)

    t = topo.detect_topology(laid((4, 2), ("data", "model"), 0, 2))
    assert t.axis_tiers == (("data", span), ("model", "loopback")) and t.n_processes == 2
    t = topo.detect_topology(laid((4, 1), ("data", "model"), 0, 1))
    assert t.axis_tiers == (("data", "loopback"), ("model", "loopback"))
    t = topo.detect_topology(laid((2, 4, 1), ("pod", "data", "model"), 1, 2))
    assert t.axis_tiers == (("pod", "dcn"), ("data", "loopback"), ("model", "loopback"))
    assert t.devices_per_pod == 4
    t = topo.detect_topology(laid((2, 4, 1), ("pod", "data", "model"), 3, 4))
    assert t.tier_for_axes(("data",)) == span


def test_mesh_workers_and_rows_without_a_group():
    m = topo.make_test_mesh(4, 2, device="cpu")
    assert m.shape == {"data": 4, "model": 2} and m.axis_names == ("data", "model")
    assert list(m.workers(4)) == [0, 1, 2, 3]
    rows = torch.arange(8.0).reshape(4, 2)
    assert m.gather_rows(rows, 4) is rows and m.sum_rows(rows, 4) is rows
    with pytest.raises(ValueError, match="without a process group"):
        m.gather_rows(rows[:2], 4)
    laid = dataclasses.replace(m, rank=1, world=2)
    assert list(laid.workers(4)) == [2, 3]
    with pytest.raises(ValueError, match="split evenly"):
        laid.workers(3)


def test_mesh_rows_on_a_one_rank_gloo_group():
    """A one-rank gloo group: every dtype the wire carries crosses the
    all-gather bit for bit; the all-reduce reduces in place; both counted."""
    import torch.distributed as dist

    from repro_torch.launch.transport import RetryPolicy, retry_call

    assert not dist.is_initialized()
    # a fresh port each attempt: another process may take a free port first
    retry_call(lambda: topo.initialize_multiprocess(f"127.0.0.1:{topo._free_port()}", 1, 0,
                                                    device="cpu", timeout_s=60.0),
               RetryPolicy(retries=2, backoff_s=0.5), retryable=(RuntimeError, OSError))
    try:
        m = topo.make_test_mesh(2, 1, device="cpu")
        assert m.world == 1 and m.backend == "gloo"
        for t in (torch.randn(2, 3, 5), torch.randn(2, 7).to(torch.bfloat16),
                  torch.arange(-6, 6, dtype=torch.int16).reshape(2, 6),
                  torch.arange(-4, 4, dtype=torch.int8).reshape(2, 4)):
            got = m.gather_rows(t, 2)
            assert got.dtype == t.dtype and torch.equal(got.view(torch.uint8),
                                                        t.view(torch.uint8))
        x = torch.randn(2, 4)
        assert torch.equal(m.sum_rows(x.clone(), 2), x)
        assert m.collectives == {"all_gather": 4, "all_reduce": 1}
        # this rank's rows' bytes: f32 2·3·5, bf16 2·7, int16 12, int8 8; f32 2·4
        assert m.payload_bytes == {"all_gather": 120 + 28 + 24 + 8, "all_reduce": 32}
        m.reset_counts()
        assert m.collectives == {} and m.payload_bytes == {}
        with pytest.raises(ValueError, match="gloo"):
            topo.make_test_mesh(2, 1, device="meta")
    finally:
        topo.shutdown()
    assert not dist.is_initialized()


def test_crash_recovery_env_helpers(monkeypatch):
    assert topo.clients_of_rank(0, 2) == jtopo.clients_of_rank(0, 2) == (0, 1)
    assert topo.clients_of_rank(1, 3) == jtopo.clients_of_rank(1, 3) == (3, 4, 5)
    monkeypatch.setenv(topo.CRASH_ENV, "1@3")
    assert topo.crash_spec_from_env() == jtopo.crash_spec_from_env() == (1, 3)
    monkeypatch.setenv(topo.DEAD_ENV, "2,3")
    monkeypatch.setenv(topo.RESUME_ENV, "4")
    assert topo.recovery_from_env() == jtopo.recovery_from_env() == ((2, 3), 4)
    text = "x\nMARINA_HB 0\nMARINA_HB 2\nMARINA_HB bad\n"
    assert topo.last_heartbeat(text) == jtopo.last_heartbeat(text) == 2
    assert topo.last_heartbeat("") == -1
