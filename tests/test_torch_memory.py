"""The device memory a call holds (``repro_torch.roofline.memory``), the
port's counterpart of XLA's ``memory_analysis``:

* scripted sequences — allocations, views, in-place and ``out=`` ops,
  frees, a storage outliving its first tensor through a view — give the
  exact peak, the operator at it, the bytes live there by allocating
  operator and the five keys, the same on the CPU
  and on meta; an argument counts at the share the device holds; a
  storage whose Python wrapper dies before it is polled until it dies;
* the dry run's steps at a small width (``_torch_parity.memory_steps``: a
  reduced Qwen1.5-0.5B train step, sync and compressed, and the paged
  decode and prefill steps, on a stand-in of a (2, 2) mesh) count the same
  on meta as on the CPU, their argument size is the dry run's
  ``arg_bytes_per_device``, and ``analyze_step``'s report writes the keys;
* off the card a kernel wrapper counts its outputs, not its plain
  version's temporaries (the paged attention's dense gather), and a
  ``shapes_only`` block counts nothing;
* against the JAX package: the reference's train steps at a small width
  (one layer, d_model 128: the compile sets the time), compiled on the CPU
  on a one-device mesh, take the port's
  argument bytes (the compressed step's 8-byte key aside: the port keeps
  the key on the host) and return the port's output bytes plus 8 bytes a
  leaf (XLA's output tuple holds a pointer a leaf); the reference donates
  the parameters and the estimator (alias = both), the port allocates new
  ones (alias 0);
* ``chip_smoke.py``'s dryrun-phase gate passes an allocator's peak from
  1 MiB below the counted one to 128 MiB above it, and fails one outside.
"""

import dataclasses
import gc

import pytest
import torch

from _torch_parity import MEMORY_STEP_NAMES, memory_steps, one_torch_thread  # noqa: F401
from repro_torch.kernels import paged
from repro_torch.kernels import ref as kref
from repro_torch.roofline import analyze_step
from repro_torch.roofline import memory as mem

DEVICES = ["cpu", "meta"]
KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes"}


def _scripted(dev):
    x = torch.empty(1000, device=dev)               # the argument: 4000 B

    def f(x):
        a = torch.empty(300, device=dev)            # 1200 → 1536
        b = x * 2                                   # 4000 → 4096
        v = b[10:20]                                # a view: nothing
        b.add_(1)                                   # in place: nothing
        torch.mul(x, 3, out=b)                      # out=: nothing
        del a                                       # −1536
        c = torch.cat([x, x])                       # 8000 → 8192: the peak
        del c
        w = torch.exp(x)[:5]                        # 4096 held by its view w
        return b, x, v, w

    return x, f


@pytest.mark.parametrize("dev", DEVICES)
def test_scripted_sequence_counts_exactly(dev):
    x, f = _scripted(dev)
    with mem.MemoryCounter((x,)) as mc:
        out = f(x)
    ma = mc.analysis(out)
    assert set(ma) == KEYS
    assert mc.peak == 4000 + 1536 + 4096 - 1536 + 8192 and mc.peak_op == "cat"
    # live at the peak by the allocating operator (the argument aside)
    assert mc.peak_by_op == {"mul": 4096, "cat": 8192}
    # live at return: x, b and exp's storage (through w)
    assert mc.live == 4000 + 4096 + 4096
    assert ma == {"argument_size_in_bytes": 4000.0,
                  "output_size_in_bytes": 4000.0 + 4000.0 + 4000.0,   # b, x (alias), exp
                  "alias_size_in_bytes": 4000.0,
                  "temp_size_in_bytes": float(mc.peak - 4000 - 12000 + 4000),
                  "generated_code_size_in_bytes": 0.0}
    assert mem.counted_peak(ma) == mc.peak
    del out
    gc.collect()
    assert mc.live == 4000   # b and exp's storage died after the call


@pytest.mark.parametrize("dev", DEVICES)
def test_storage_dies_with_its_last_tensor(dev):
    with mem.MemoryCounter() as mc:
        t = torch.empty(1024, device=dev)
        v = t[1:]
        del t                    # the storage lives on in v
        torch.zeros(1, device=dev)
        assert mc.live == 4096
        del v
        torch.zeros(1, device=dev)
        assert mc.live == 0
    assert mc.peak == 4096 + 512


@pytest.mark.parametrize("dev", DEVICES)
def test_frees_are_confirmed_where_a_new_peak_could_be_set(dev):
    """The live count holds a dead storage until an allocation could set a
    new peak; then the confirmed count decides, so the peak is exact."""
    with mem.MemoryCounter() as mc:
        a = torch.empty(2048, device=dev)       # 8192: the peak
        del a
        b = torch.empty(1024, device=dev)       # 8192 + 4096 > the peak: a confirmed dead
        assert mc._bytes == 4096 and not mc._marked
        del b
        c = torch.empty(512, device=dev)        # 4096 + 2048 ≤ the peak: nothing confirmed
        assert mc._bytes == 4096 + 2048 and mc._marked
        d = torch.empty(1536, device=dev)       # b confirmed dead: 2048 + 6144, not above
        assert mc._bytes == 8192 and mc.peak == 8192 and mc.peak_by_op == {"empty": 8192}
        e = torch.empty(128, device=dev)        # 8704: the new peak
        assert mc.peak == 8192 + 512 and mc.live == 8192 + 512
        del c, d, e


def test_argument_shares_and_other_devices():
    params, batch = torch.empty(100), torch.empty((16, 64), dtype=torch.int32)
    with mem.MemoryCounter((params, {"tokens": batch}, params), shares=(1.0, 1 / 16, 1.0)) as mc:
        torch.empty(10, device="meta")      # another device: not counted
    assert mc.argument == 400 + 16 * 64 * 4 // 16   # params counted once
    assert mc.peak == mc.argument and mc.peak_op is None


def test_a_storage_whose_wrapper_dies_first_stays_counted():
    """A storage whose Python object dies while the storage lives on stays
    marked and counted until it dies."""
    with mem.MemoryCounter() as mc:
        t = torch.empty(256)
        cd = t.untyped_storage()._cdata
        mc._live[cd][1] = None   # its weak reference gone, as with its object
        mc._died(cd, None)
        assert mc.live == 1024 and cd in mc._marked
        del t                    # no callback: the mark alone frees it
        torch.zeros(1)
    assert mc.live == 0 and not mc._marked and mc.peak == 1024


@pytest.fixture(scope="module")
def counted():
    """Each small step's memory analysis and report on the CPU and meta."""
    out = {}
    for dev in DEVICES:
        for name, (fn, args, shares, in_bytes) in memory_steps(dev).items():
            rep = analyze_step(fn, *args, arg_shares=shares)
            out[dev, name] = (rep, in_bytes)
    return out


@pytest.mark.parametrize("name", MEMORY_STEP_NAMES)
def test_small_steps_count_the_same_on_meta_as_on_the_cpu(counted, name):
    (cpu, in_bytes), (meta, _) = counted["cpu", name], counted["meta", name]
    assert cpu.memory_analysis == meta.memory_analysis
    assert cpu.peak_memory_per_device == meta.peak_memory_per_device
    assert cpu.peak_memory_op == meta.peak_memory_op is not None
    ma = meta.memory_analysis
    assert ma["argument_size_in_bytes"] == in_bytes
    assert meta.peak_memory_per_device == mem.counted_peak(ma) > in_bytes
    d = meta.to_dict()
    assert d["memory_analysis"] == ma and d["peak_memory_op"] == meta.peak_memory_op
    assert "allocated_at_entry" not in d
    if name.startswith("paged"):   # the pool is updated in place and returned
        assert ma["alias_size_in_bytes"] > 0
    else:                          # new parameters and estimator
        assert ma["alias_size_in_bytes"] == 0 and ma["output_size_in_bytes"] > 0


@pytest.mark.parametrize("dev", DEVICES)
def test_a_plain_version_counts_as_its_kernels_outputs(dev):
    """Off the card the paged attention's plain version gathers the dense
    cache (S × max_pages·P × KV × hd, K and V); the wrapper counts its
    (S, H, hd) output, as the kernel allocates."""
    S, H, KV, hd, P, maxp, npage = 2, 4, 2, 32, 16, 8, 17
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((S, H, hd), generator=gen).to(dev)
    kp = torch.randn((npage, P, KV, hd), generator=gen).to(dev)
    vp = torch.randn((npage, P, KV, hd), generator=gen).to(dev)
    tables = (1 + torch.arange(S * maxp, dtype=torch.int32).reshape(S, maxp) % 16).to(dev)
    n_valid = torch.tensor([100, 37], dtype=torch.int32).to(dev)
    args = (q, kp, vp, tables, n_valid)
    with mem.MemoryCounter(args) as kernel:
        out = paged.paged_attn_decode(*args)
    with mem.MemoryCounter(args) as plain:
        out_ref = kref.paged_attn_decode_ref(*args)
    dense = 2 * S * maxp * P * KV * hd * 4
    assert kernel.peak - kernel.argument == mem.rounded(S * H * hd * 4)
    assert kernel.peak_op == "paged_attn_decode"
    assert plain.peak - plain.argument > dense
    assert kernel.analysis(out)["output_size_in_bytes"] == S * H * hd * 4
    assert plain.analysis(out_ref)["output_size_in_bytes"] == S * H * hd * 4


def test_shapes_only_counts_nothing():
    with mem.MemoryCounter() as mc:
        with mem.shapes_only():
            big = torch.empty((1 << 20, 1 << 10), device="meta")
            torch.zeros_like(big)
        torch.empty(10, device="meta")
    assert mc.peak == 512 and big.shape[0] == 1 << 20


def test_sizes_against_the_reference():
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.launch.distributed import build_train_steps as j_build
    from repro.models import reduced as j_reduced
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.launch.topology import production_topology
    from repro_torch.models import reduced

    B, S = 4, 32
    jarch = dataclasses.replace(j_get_arch("qwen1.5-0.5b"),
                                model=j_reduced(j_get_arch("qwen1.5-0.5b").model, layers=1,
                                                d_model=128))
    auto = jax.sharding.AxisType.Auto
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    jb = j_build(jarch, jmesh, False, global_batch=B, seq_len=S)
    arch = get_arch("qwen1.5-0.5b")
    arch = dataclasses.replace(arch, model=reduced(arch.model, layers=1, d_model=128))
    mesh = dryrun.StandInMesh(axis_names=("data", "model"), sizes=(1, 1),
                              device=torch.device("cpu"), group="stand-in", world=1, model=1)
    b = build_train_steps(arch, mesh, False, global_batch=B, seq_len=S,
                          topology=production_topology())
    torch.manual_seed(0)
    args, in_bytes, shares = dryrun.train_inputs(
        b, arch, dict(kind="train", seq_len=S, global_batch=B), "cpu")
    leaves = 2 * len(jax.tree.leaves(jb.fns["sync_step"][1][0]))
    for name, key_bytes in (("sync_step", 0), ("compressed_step", 8)):
        fn, jargs = jb.fns[name]
        with jmesh:
            ref = fn.lower(*jargs).compile().memory_analysis()
        ma = analyze_step(b.fns[name], *args[name], arg_shares=shares[name]).memory_analysis
        assert ma["argument_size_in_bytes"] == in_bytes[name]
        assert ma["argument_size_in_bytes"] + key_bytes == ref.argument_size_in_bytes
        assert ma["output_size_in_bytes"] + 8 * leaves == ref.output_size_in_bytes
        assert ref.alias_size_in_bytes == ma["output_size_in_bytes"]
        assert ma["alias_size_in_bytes"] == 0


def test_chip_smoke_memory_gate():
    import chip_smoke

    gb = 1e9
    ma = {"argument_size_in_bytes": 1 * gb, "output_size_in_bytes": 1 * gb,
          "alias_size_in_bytes": 0.0, "temp_size_in_bytes": 12 * gb,
          "generated_code_size_in_bytes": 0.0}
    mib = 2**20
    for allocator, ok in ((14 * gb, True), (14 * gb + 100 * mib, True),
                          (14 * gb + 128 * mib, True), (14 * gb + 129 * mib, False),
                          (14.2 * gb, False), (14 * gb - 512 * 1024, True),
                          (14 * gb - mib, True), (14 * gb - 2 * mib, False)):
        entry = {"memory_analysis": ma, "peak_memory_op": "mm",
                 "peak_memory_per_device": allocator + 3 * gb, "allocated_at_entry": 4 * gb}
        entry["memory_vs_allocator"] = mem.against_allocator(entry)
        assert entry["memory_vs_allocator"]["within"] == ok, allocator
        if ok:
            chip_smoke._check_memory("step", entry)
        else:
            with pytest.raises(chip_smoke.SmokeFailure):
                chip_smoke._check_memory("step", entry)
