"""The inner groups' sums (``Mesh.model_sum``, ``Mesh.fsdp_sum``): a
rank-ordered reduce-scatter then an all-gather (``Mesh._group_sum``).

On gloo CPU clusters of 3 and 8 ranks, for every inner group size g the
world splits into (3; 2, 4, 8), along the model axis and the data axis
inside a worker, in float32 and bfloat16, on shapes whose element count g
does not divide (the padding) and on one it does:

1. every rank's sum is bit-equal to the partials added in rank order
   (``acc = P[0]``, then ``acc + P[k]``), computed on the rank itself
   from the same numpy draws;
2. it is bit-equal to the all-gather of the partials followed by that
   rank-ordered add, the design the helper replaced;
3. the mesh counts one ``<axis>/all-to-all`` and one ``<axis>/all-gather``
   a sum at g > 2, priced by ``roofline.collective_stats_from_mesh`` at
   2(g − 1)·L bytes a rank for the padded L = ceil(|t|/g) elements a row:
   2(g − 1)/g of ``t`` where g divides it; at g = 2 one all-gather of
   ``t``, priced ``t`` once, as before.

In this process: the dry run's stand-in of one production device
(``dryrun.StandInMesh``, m = D = 16, on meta) prices one sum at
2·15/16 of ``t``, and its output keeps ``t``'s shape and dtype.
"""

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.launch import dryrun
from repro_torch.launch.topology import spawn_local_cluster
from repro_torch.roofline import collective_stats_from_mesh

_PROG = r"""
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import topology as topo
from repro_torch.roofline import collective_stats_from_mesh

pid, world = topo.init_from_env(device="cpu")
SHAPES = ((5, 7), (3,), (1,), (2, 48, 3))
DTYPES = (torch.float32, torch.bfloat16)
checked = []
for g in (2, 3, 4, 8):
    if world % g:
        continue
    for axis in ("model", "fsdp"):
        if axis == "model":
            mesh = topo.make_mesh((world // g, g), ("data", "model"), device="cpu")
            me, size, total = mesh.model_rank, mesh.model, mesh.model_sum
            group = mesh.model_group
        else:
            mesh = topo.make_mesh((world // g, g, 1), ("pod", "data", "model"), device="cpu",
                                  fsdp=True)
            me, size, total = mesh.fsdp_rank, mesh.fsdp, mesh.fsdp_sum
            group = mesh.fsdp_group
        assert size == g, (axis, size, g)
        team = pid // g   # the inner group this rank sits in: its ranks are consecutive
        for si, shape in enumerate(SHAPES):
            for dtype in DTYPES:
                rng = np.random.default_rng([g, si, team, DTYPES.index(dtype)])
                parts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                          * 10.0 ** rng.integers(-3, 4)).to(dtype)
                         for _ in range(g)]
                want = parts[0]
                for p in parts[1:]:
                    want = want + p
                mesh.reset_counts()
                got = total(parts[me].clone())
                assert got.shape == want.shape and got.dtype == dtype, (got.shape, got.dtype)
                assert torch.equal(got, want), (axis, g, shape, dtype)
                prefix = axis + "/"
                counts = dict(mesh.op_counts)
                stats = collective_stats_from_mesh(mesh)
                n, elt = parts[0].numel(), parts[0].element_size()
                if g == 2:
                    assert counts == {prefix + "all-gather": 1}, counts
                    assert stats.by_kind_bytes == {prefix + "all-gather": float(n * elt)}
                else:
                    L = -(-n // g)
                    assert counts == {prefix + "all-to-all": 1, prefix + "all-gather": 1}, counts
                    assert stats.by_kind_bytes == {prefix + "all-to-all": (g - 1) * L * elt,
                                                   prefix + "all-gather": (g - 1) * L * elt}, (
                        stats.by_kind_bytes, L)
                    if n % g == 0:
                        assert stats.per_device_bytes == 2 * (g - 1) * n * elt / g
                # the design it replaced: the partials all-gathered, added in rank order
                old = mesh._gather_parts(parts[me].clone(), g, group, "old", "old/all-gather")
                acc = old[0]
                for k in range(1, g):
                    acc = acc + old[k]
                assert torch.equal(got, acc), (axis, g, shape, dtype)
                checked.append((axis, g, si, str(dtype)))
print(f"GROUP_SUM_OK {pid} {len(checked)}", flush=True)
topo.shutdown()
"""

#: cases a rank checks: g over the divisors of the world above 1, two axes,
#: four shapes, two dtypes
_CASES = {3: 1 * 2 * 4 * 2, 8: 3 * 2 * 4 * 2}


@pytest.mark.parametrize("world", [3, 8])
def test_group_sums_bit_equal_and_priced_on_gloo_ranks(world):
    res = spawn_local_cluster(_PROG, num_processes=world, devices_per_process=1,
                              timeout=300.0, extra_env={"OMP_NUM_THREADS": "1"})
    for pid, r in enumerate(res):
        assert r.returncode == 0, r.stderr[-4000:]
        assert f"GROUP_SUM_OK {pid} {_CASES[world]}" in r.stdout, r.stdout[-2000:]


@pytest.mark.parametrize("axis", ["model", "fsdp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stand_in_prices_a_production_sum(axis, dtype):
    """One sum of a (4, 4096, 896) activation on device 0's stand-in of the
    (16, 16) production mesh (the model axis) and of the fsdp layout's
    data axis: 2·15/16 of its bytes, half in the all-to-all, half in the
    all-gather."""
    mesh = dryrun.StandInMesh(axis_names=("pod", "data", "model"), sizes=(2, 16, 16),
                              device=torch.device("meta"), group="stand-in", world=2,
                              model=16, fsdp=16)
    t = torch.empty((4, 4096, 896), dtype=dtype, device="meta")
    out = mesh.model_sum(t) if axis == "model" else mesh.fsdp_sum(t)
    assert out.shape == t.shape and out.dtype == dtype and out.is_meta
    nbytes = t.numel() * t.element_size()
    stats = collective_stats_from_mesh(mesh)
    assert mesh.op_counts == {f"{axis}/all-to-all": 1, f"{axis}/all-gather": 1}
    assert stats.by_kind_bytes == {f"{axis}/all-to-all": 15 * nbytes / 16,
                                   f"{axis}/all-gather": 15 * nbytes / 16}
    assert stats.per_device_bytes == 2 * 15 * nbytes / 16


def test_stand_in_sum_keeps_shape_on_the_cpu():
    """On CPU tensors the stand-in's exchanges return copies of its own rows
    (the values are not a sum over ranks); the helper's padding, views and
    adds give ``t``'s shape, and a shape 16 does not divide is padded and
    cut back."""
    mesh = dryrun.StandInMesh(axis_names=("data", "model"), sizes=(16, 16),
                              device=torch.device("cpu"), group="stand-in", world=16,
                              model=16)
    t = torch.arange(35, dtype=torch.float32).reshape(5, 7)
    out = mesh.model_sum(t)
    assert out.shape == (5, 7)
    # row k of the stand-in's exchange is its own row k, so each element's
    # sum runs over the 16 rows of the padded (16, 3) view at its column,
    # and the all-gather repeats that row 16 times
    rows = torch.cat([t.reshape(-1), t.new_zeros(13)]).view(16, 3)
    want = rows[0]
    for k in range(1, 16):
        want = want + rows[k]
    assert torch.equal(out, want.repeat(16)[:35].view(5, 7))
