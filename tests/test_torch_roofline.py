"""The port's roofline (``repro_torch.roofline``) against ``repro.roofline``.

* the arithmetic — ``RooflineReport`` (every property and ``to_dict``, with
  and without a topology), ``alpha_beta_disagreement``,
  ``decode_bandwidth_bound_s`` and ``prefill_sharing_savings`` — equals the
  reference's bit for bit given the same inputs and the same ``HW``
  values; the port's ``HW`` defaults are the H100 SXM's published figures;
* ``analyze_step``'s counters, exactly: one matmul is 2·M·N·K FLOPs and
  its inputs plus its output in bytes (a transposed view adds nothing),
  and its output's bytes of memory at its peak;
  a reduced Qwen1.5-0.5B's forward and backward count 6·D·(N − the norm
  and bias parameters) plus the attention's 12·L·B·S²·H·hd FLOPs (remat
  off), and with remat on the recomputed forward puts ``model_flops`` at
  0.70–0.80 of the count;
* ``collective_stats_from_mesh`` prices what a mesh counted under the ring
  rule by collective and books it under the worker axes' tier; a world of
  one rank moves nothing over a link; ``analyze_step`` reads only the
  call's own collectives.
"""

import dataclasses
import itertools

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.launch import topology as jtopo
from repro.roofline import analysis as jra
from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_flatten_with_path, tree_leaves
from repro_torch.launch import param_math as pm
from repro_torch.launch import topology as topo
from repro_torch.models import init_params, lm_loss, reduced
from repro_torch.roofline import analysis as ra

H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)


def test_hw_defaults_are_the_h100s():
    assert dataclasses.asdict(ra.HW()) == H100
    assert ra.H100_F32_PEAK_FLOPS == 67e12


def _stats(mod, tiers: bool):
    kw = dict(per_device_bytes=3.5e9, counts={"all-gather": 3, "all-reduce": 1},
              by_kind_bytes={"all-gather": 3e9, "all-reduce": 0.5e9})
    if tiers:
        kw.update(by_tier_bytes={"ici": 3e9, "dcn": 0.5e9},
                  by_tier_counts={"ici": 3, "dcn": 1})
    return mod.CollectiveStats(**kw)


def _topology(mod):
    return mod.Topology(axis_tiers=(("pod", "dcn"), ("data", "ici")), n_devices=8,
                        n_processes=2, devices_per_pod=4)


@pytest.mark.parametrize("tiers", [False, True])
@pytest.mark.parametrize("model_flops", [None, 2.28e13])
@pytest.mark.parametrize("peak", [989e12, 67e12])
def test_report_equals_the_reference(tiers, model_flops, peak):
    reps = []
    for mod, tmod in ((ra, topo), (jra, jtopo)):
        hw = mod.HW(**dict(H100, peak_flops=peak))
        reps.append(mod.RooflineReport(
            flops_per_device=3.1e13, bytes_per_device=4.4e11, collective=_stats(mod, tiers),
            n_devices=4, hw=hw, model_flops_total=model_flops, peak_memory_per_device=7e10,
            topology=_topology(tmod) if tiers else None))
    mine, ref = reps
    for prop in ("compute_s", "analytic_compute_s", "memory_s", "collective_s_flat",
                 "collective_s", "dominant", "useful_ratio"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.to_dict() == ref.to_dict()


def test_alpha_beta_disagreement_equals_the_reference():
    vals = (0.0, -1.0, 1e-6, 3e-4, 0.1, 2.0, 7.5)
    for rec, mod, f in itertools.product(vals, vals, (2.0, 1.5)):
        assert ra.alpha_beta_disagreement(rec, mod, f) == jra.alpha_beta_disagreement(
            rec, mod, f)


@pytest.mark.parametrize("with_topology", [False, True])
def test_decode_bound_equals_the_reference(with_topology):
    for kv, n_dev, coll, nc, tier in ((3.1e8, 1, 0.0, 0, "ici"), (2.2e9, 4, 1.7e7, 48, "dcn"),
                                      (0.0, 2, 5e5, 3, "loopback")):
        kw = dict(collective_bytes=coll, n_collectives=nc, tier=tier)
        got = ra.decode_bandwidth_bound_s(kv, 1.855950848e9, n_dev, ra.HW(),
                                          topology=_topology(topo) if with_topology else None,
                                          **kw)
        want = jra.decode_bandwidth_bound_s(kv, 1.855950848e9, n_dev, jra.HW(**H100),
                                            topology=(_topology(jtopo) if with_topology
                                                      else None), **kw)
        assert got == want
    # the default HW is the H100's: Qwen1.5-0.5B's f32 parameters stream in
    # 1.856 GB / 3.35 TB/s
    assert ra.decode_bandwidth_bound_s(0.0, 4.0 * 463_987_712, 1)["hbm_s"] == (
        4.0 * 463_987_712 / 3.35e12)


def test_prefill_sharing_equals_the_reference():
    for un, sh in ((4096, 1024), (100, 0), (10, 50)):
        got = ra.prefill_sharing_savings(un, sh, 2 * 4.6e8, 1.2e4, 2, ra.HW())
        want = jra.prefill_sharing_savings(un, sh, 2 * 4.6e8, 1.2e4, 2, jra.HW(**H100))
        assert got == want


def test_one_matmul_counts_exactly():
    M, K, N = 8, 32, 16
    x, w = torch.randn(M, K), torch.randn(N, K)
    rep = ra.analyze_step(lambda: x @ w.t())
    assert rep.flops_per_device == 2 * M * N * K
    assert rep.bytes_per_device == 4 * (M * K + K * N + M * N)
    # the counted memory: no argument, the (M, N) output live at return
    assert rep.peak_memory_per_device == 4 * M * N and rep.collective.per_device_bytes == 0
    assert rep.memory_analysis["output_size_in_bytes"] == 4 * M * N
    assert rep.memory_analysis["temp_size_in_bytes"] == 0 and rep.peak_memory_op == "mm"
    rep2 = ra.analyze_step(lambda a, b: torch.add(a, b, alpha=2.0), x, x)
    assert rep2.flops_per_device == 0 and rep2.bytes_per_device == 4 * 2 * M * K


def _lm_step(remat: bool):
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b").model, layers=2, d_model=64),
                              remat=remat)
    params = init_params(0, cfg, torch.float32, device="cpu")
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]

    def step():
        torch.autograd.grad(lm_loss(params, cfg, toks), leaves)

    return cfg, params, B, S, step


def test_lm_forward_backward_flops_against_model_flops():
    cfg, params, B, S, step = _lm_step(remat=False)
    D = B * S
    rep = ra.analyze_step(step, model_flops_total=pm.model_flops(cfg, D))
    vectors = sum(leaf.numel() for path, leaf in tree_flatten_with_path(params)[0]
                  if path[-1].key in ("final_norm", "ln1", "ln2", "bq", "bk", "bv"))
    n = pm.count_params(cfg)
    L, H, hd = 2, cfg.num_heads, cfg.resolved_head_dim
    assert rep.model_flops_total == 6.0 * n * D
    assert rep.flops_per_device == 6 * D * (n - vectors) + 12 * L * B * S * S * H * hd
    assert 0.9 < rep.useful_ratio < 1.0
    cfg_r, _, _, _, step_r = _lm_step(remat=True)
    rep_r = ra.analyze_step(step_r, model_flops_total=pm.model_flops(cfg_r, D))
    assert 0.70 < rep_r.useful_ratio < 0.80
    assert rep_r.bytes_per_device > 0 and rep_r.dominant in ("compute", "memory")


def _mesh(world: int):
    m = topo.Mesh(axis_names=("data", "model"), sizes=(4, 1), device=torch.device("cpu"))
    m.world = world
    return m


@pytest.mark.parametrize("world", [2, 4])
def test_collective_stats_price_the_mesh_counts(world):
    m = _mesh(world)
    for kind, nbytes, op in (("all_gather", 100, "all-gather"), ("all_gather", 50, "all-gather"),
                             ("all_reduce", 64, "all-reduce"), ("gather_state", 10, "send"),
                             ("all_gather", 7, "broadcast")):
        m._count(kind, nbytes, op)
    g = world
    want = {"all-gather": 150 * (g - 1), "all-reduce": 2.0 * 64 * (g - 1), "send": 10.0,
            "broadcast": 7.0}
    t = topo.Topology(axis_tiers=(("data", "dcn"), ("model", "loopback")), n_devices=4,
                      n_processes=world)
    s = ra.collective_stats_from_mesh(m, t)
    assert s.by_kind_bytes == want
    assert s.counts == {"all-gather": 2, "all-reduce": 1, "send": 1, "broadcast": 1}
    assert s.per_device_bytes == sum(want.values())
    assert s.by_tier_bytes == {"dcn": sum(want.values())} and s.by_tier_counts == {"dcn": 5}
    assert ra.collective_stats_from_mesh(m).by_tier_bytes == {}
    # since a snapshot: only what came after
    snap = ra.mesh_counts(m)
    m._count("all_gather", 8, "all-gather")
    assert ra.collective_stats_from_mesh(m, since=snap).by_kind_bytes == {
        "all-gather": 8 * (g - 1)}
    assert ra.collective_stats_from_mesh(_mesh(1)).per_device_bytes == 0.0


def test_collective_stats_price_the_model_axis_on_its_tier():
    """A 2-rank round's counts (one worker group, two model ranks): the
    worker-axis collectives run in a group of one and move nothing over a
    link; the model-axis ones (``model/...``) are priced for the 2 ranks of
    the model group, under the model axis's tier."""
    m = topo.Mesh(axis_names=("data", "model"), sizes=(4, 2), device=torch.device("cpu"),
                  world=1, model=2)
    for kind, nbytes, op in (("all_gather", 26632, "all-gather"),
                             ("model/sum", 3153792, "model/all-gather"),
                             ("model/gather_on_use", 8192, "model/all-gather"),
                             ("model/broadcast", 256, "model/broadcast")):
        m._count(kind, nbytes, op)
    t = topo.Topology(axis_tiers=(("data", "loopback"), ("model", "dcn")), n_devices=8,
                      n_processes=2)
    s = ra.collective_stats_from_mesh(m, t)
    want = {"model/all-gather": (3153792 + 8192) * 1, "model/broadcast": 256.0}
    assert s.by_kind_bytes == want
    assert s.counts == {"model/all-gather": 2, "model/broadcast": 1}
    assert s.by_tier_bytes == {"dcn": sum(want.values())} and s.by_tier_counts == {"dcn": 3}
    # four ranks: two worker groups of two model ranks; both axes price
    m.world = 2
    s = ra.collective_stats_from_mesh(m, dataclasses.replace(
        t, axis_tiers=(("data", "dcn"), ("model", "ici")), n_processes=4))
    assert s.by_kind_bytes == {"all-gather": 26632.0 * 1, **want}
    assert s.by_tier_bytes == {"dcn": 26632.0, "ici": sum(want.values())}


def test_analyze_step_reads_only_the_calls_collectives():
    m = _mesh(2)
    m._count("all_gather", 1000, "all-gather")

    def step():
        m._count("all_gather", 40, "all-gather")
        return torch.ones(3) * 2

    rep = ra.analyze_step(step, mesh=m, topology=topo.detect_topology(_mesh(1)))
    assert rep.collective.by_kind_bytes == {"all-gather": 40.0}
    assert rep.collective.by_tier_bytes == {"loopback": 40.0}
