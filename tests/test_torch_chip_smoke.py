"""``chip_smoke.py``'s phases rehearsed on the CPU at a tiny size.

The script's card run checks that each of its fourteen paths launches exactly
``EXPECTED_LAUNCHES``, draws c_k = 1, 0, 1, 0 and books the wire formulas'
up and down bits every round. Here ``run_main_path`` runs with a reduced
dense LM on the CPU (``chip_smoke.DEVICE = "cpu"``; the profile phase and
the device-memory counters stubbed), every kernel wrapper counting a launch
where it returns its plain version, so a drift between those expectations
and the code shows without a card. The small-input phase (the randk_qsgd
engine's launches and ledger, the baselines' ledgers, the robust and fault
runs' launches and the drop ledger, the deadline contract) and the QSGD,
natural and trimmed kernel phases (shapes, edge values, the timing table, with a
host clock in place of the CUDA events) are rehearsed the same way, and so
are the per-leaf wires of the small-input phase (SharedRandK, CorrelatedQ,
a per-leaf QSGD downlink) and its checkpoint round trip of a carry state
with bf16 leaves, the flat-wire kernel phase and the wire phase
(``WIRE_LAUNCHES``, the seeded payloads, the gathers, the plain run), and
the resume phase (U, A and B on the tiny LM: launches, c_k, the ledger,
B bit-equal to U, the checkpoint directory removed) with its helpers. The
families phase runs its three legs on the families' configs with every
segment kept at d_model 64 (then cut to the phase's depth): the
Llama-4-Scout paths' launch counts from the ServeReport, the static legs'
teacher-forced check, the report's keys and cuts; and the small-input
families through the trainer with the carry path's exact launches. The
recurrent phase's constants are checked here without running it (the mLSTM
chunk rule, recurrentgemma's window, the ``xc`` path's launches); its
rehearsal is ``tests/test_torch_chip_smoke_recurrent.py``. The launch
phase runs its two paths on the tiny LM over a one-rank gloo group brought
up through ``topology.init_from_env`` (the card's is nccl): launches by
round, the ledgers, the collectives, the kernel and plain runs bit-equal,
the group destroyed; and the transport's per-leaf widths of the kernel
phase run at a tiny row count.
"""

import dataclasses
import os
import sys

import pytest
import torch

import repro_torch.configs as configs
from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch import kernels
from repro_torch.kernels import epilogue, paged, permk, quantize, randk
from repro_torch.models import ModelConfig, dense_stack

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TINY = ModelConfig(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
                   num_kv_heads=2, d_ff=128, vocab_size=256, segments=dense_stack(1),
                   qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0)


def _count_plain_launches(monkeypatch):
    """Every kernel wrapper counts a launch where it returns its plain
    version on CPU tensors (the int8 page write under ``absmax_quant_rows``,
    as on the card)."""
    for mod in (epilogue, paged, permk, quantize, randk):
        for name, fn in kernels.KERNELS.items():
            if getattr(mod, name, None) is fn:
                def counted(*a, _fn=fn, **k):
                    out = _fn(*a, **k)
                    _fn.launches += 1
                    return out
                monkeypatch.setattr(mod, name, counted)

    def counted_write(*a, _fn=quantize.absmax_quant_write_pages, **k):
        out = _fn(*a, **k)
        kernels.KERNELS["absmax_quant_rows"].launches += 1
        return out
    monkeypatch.setattr(quantize, "absmax_quant_write_pages", counted_write)


def test_main_paths_launch_and_book_what_chip_smoke_expects(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "profile_step", lambda *a: None)
    monkeypatch.setattr(configs, "get_arch",
                        lambda name: type("Arch", (), {"model": TINY}))
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    _count_plain_launches(monkeypatch)
    report = {}
    launches = chip_smoke.run_main_path(report)  # raises SmokeFailure on a drift
    kernels.reset_launch_counts()
    assert set(launches) == set(chip_smoke.PATHS)
    for path, counts in launches.items():
        assert {k: v for k, v in counts.items() if v} == chip_smoke.EXPECTED_LAUNCHES[path]
    runs = report["main_path"]["runs"]
    assert all(run["c_k"] == chip_smoke.EXPECTED_C_K for run in runs.values())


def test_small_input_phase_runs_as_chip_smoke_expects(monkeypatch):
    """Every main path and the randk_qsgd engine agree with their plain
    versions (on the CPU both are the plain versions; the launch counts and
    ledgers are what is checked), and each baseline books
    ``tree_payload_bits`` every round without a launch."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _count_plain_launches(monkeypatch)
    report = {}
    chip_smoke.check_small_input(report)  # raises SmokeFailure on a drift
    kernels.reset_launch_counts()
    assert set(report["small_input_baselines"]) == {
        f"{m}_{c}" for m, c in chip_smoke.BASELINES}
    assert set(report["small_input_robust"]) == set(chip_smoke.SMALL_ROBUST)
    assert report["small_input_deadline"]["uploaded_compressed"] == chip_smoke.N_WORKERS - 1
    assert set(report["small_input_leafwise"]) == set(chip_smoke.SMALL_LEAFWISE)
    ck = report["small_input_checkpoint"]
    assert 0 < ck["bf16_leaves"] < ck["leaves"]  # params and h cast, g kept f32


def test_natural_kernel_phase_runs_at_a_tiny_width(monkeypatch):
    """The natural kernel phase's shapes, edge-value input, bounds and table
    rows, with a host clock in place of the CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    report = {}
    rows = chip_smoke.check_natural(3, "cpu", report)
    assert set(rows) == {"natural_block_workers", "natural_dequant_mean",
                         "natural_epilogue"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
        assert row["max_abs_err"] == 0.0
    counts = {(t["kernel"], t["n"]) for t in report["kernels_natural"]}
    # every worker count a main path gives them: the uplink (4), PP-MARINA's
    # cohort (2, under the median) and the downlink's one payload (1)
    assert counts == {(k, n) for n in (4, 2, 1) for k in rows}
    assert set(chip_smoke.SOURCES) == set(kernels.KERNELS)
    at_n = rows["natural_epilogue"]["at_n"]
    assert set(at_n) == {f"n{n}_{x}" for n in (4, 2, 1) for x in ("float32", "bfloat16")}
    # 13 B a coordinate at n = 1 with x bf16 (a code, g and g' in f32, x and x'
    # in bf16), 4 more a block (its scale)
    assert at_n["n1_bfloat16"]["bound_ms"] == pytest.approx(
        (13 * 3 * chip_smoke.BLOCK + 4 * 3) / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_randk_kernel_phase_runs_at_a_tiny_width(monkeypatch):
    """The RandK-wire kernel phase: the production shape cut to 3 blocks,
    PP's cohort and the forced-duplicates shape, the epilogues, and
    ``scatter_accum`` timed at the production and the wire phase's jittered
    offsets against its bound and ``index_add``, with a host clock in place
    of the CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    for name in ("empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    report = {}
    rows = chip_smoke.check_kernels(3, "cpu", report)
    assert set(rows) == {"randk_seeded_workers", "scatter_accum", "scatter_epilogue",
                         "mean_epilogue"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert set(report) == {f"kernels_{k}" for k in chip_smoke.randk_shapes(3)}
    scatter = rows["scatter_accum"]
    assert scatter["max_abs_err"] == 0.0 and scatter["library_ms"] == 1.0
    # the pairs read once (n·nblk·kb · 8 B), the row written once (nblk·B · 4 B)
    nbytes = chip_smoke.N_WORKERS * 3 * chip_smoke.KB * 8 + 3 * chip_smoke.BLOCK * 4
    assert scatter["bytes"] == scatter["wire"]["bytes"] == nbytes
    assert scatter["wire"]["library_ms"] == 1.0 and scatter["wire"]["max_abs_err"] == 0.0


def test_qsgd_kernel_phase_runs_at_a_tiny_width(monkeypatch):
    """The packed-QSGD kernel phase's worker counts, bounds and table rows,
    and qsgd_epilogue's times at every (n, x dtype) against 1.3× its bound,
    with a host clock in place of the CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    report = {}
    rows = chip_smoke.check_quantize(3, "cpu", report)
    assert set(rows) == {"qsgd_block_workers", "nibble_pack", "nibble_unpack",
                         "qsgd_dequant_mean", "qsgd_epilogue"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert rows["qsgd_epilogue"]["max_abs_err"] == 0.0
    assert rows["qsgd_dequant_mean"]["max_abs_err"] == 0.0
    assert set(rows["qsgd_dequant_mean"]["at_n"]) == {"n4_float32", "n1_float32"}
    at_n = rows["qsgd_epilogue"]["at_n"]
    assert set(at_n) == {f"n{n}_{x}" for n in (4, 1) for x in ("float32", "bfloat16")}
    # 17 B a coordinate at n = 1 with x f32 (1 level, g, x, g', x'), 3 more a worker
    assert at_n["n1_float32"]["bound_ms"] == pytest.approx(
        (17 * 3 * chip_smoke.BLOCK + 4 * 3) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert at_n["n4_float32"]["bound_ms"] == rows["qsgd_epilogue"]["bound_ms"]


def test_trimmed_kernel_phase_runs_at_a_tiny_width(monkeypatch):
    """The trimmed kernel phase's windows, edge rows, bounds and table rows,
    with a host clock in place of the CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TRIM_SMALL_NBLK", 2)
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    report = {}
    rows = chip_smoke.check_trimmed(3, "cpu", report)
    assert set(rows) == {"trimmed_delta_epilogue", "trimmed_sync_epilogue"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
        assert row["max_abs_err"] == 0.0
    timed = {(t["kernel"], t["n"]) for t in report["kernels_trimmed"]}
    assert timed == {(k, n) for n in (4, 2) for k in rows}
    assert rows["trimmed_delta_epilogue"]["bytes"] == (4 + 4) * 4 * 3 * chip_smoke.BLOCK


TINY_GQA = ModelConfig(name="tiny-gqa", arch_type="dense", d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=256, segments=dense_stack(2),
                       qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0)


def _serve_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("reset_peak_memory_stats", "empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    _count_plain_launches(monkeypatch)


def test_serve_kernel_phase_runs_at_a_tiny_shape(monkeypatch):
    """The serving kernels' phase: edge rows, shapes, bounds, the SDPA
    comparison and the table rows, with a host clock for the CUDA events."""
    _serve_on_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_kernel_ms", lambda fn, n=5: (fn(), {
        "paged_attn_decode_kernel": 0.5, "sm90_gemm": 2.0, "copy": 0.25})[1])
    monkeypatch.setattr(chip_smoke, "PAGED_SHAPES", {"serve": (3, 4, 4, 64, 4, 5),
                                                     "gqa_stress": (4, 8, 1, 128, 4, 6)})
    monkeypatch.setattr(chip_smoke, "ABSMAX_SHAPES", {"serve_decode": (12, 64),
                                                      "large": (40, 128)})
    monkeypatch.setattr(chip_smoke, "PAGE_WRITE_SHAPES", {"serve_decode": (3, 2, 4, 64),
                                                          "serve_prefill": (9, 6, 4, 64)})
    monkeypatch.setattr(chip_smoke, "PAGE_WRITE_POOL", (7, 4))
    report = {}
    rows = chip_smoke.check_serve_kernels("cpu", report)
    kernels.reset_launch_counts()
    assert set(rows) == {"absmax_quant_rows", "absmax_dequant_rows", "paged_attn_decode"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert rows["paged_attn_decode"]["max_abs_err"] == 0.0  # plain against plain
    assert rows["absmax_quant_rows"]["shape"] == "write_serve_decode"
    assert rows["absmax_quant_rows"]["device_ms"] == 1.0
    timed = {(t["kernel"], t["shape"]) for t in report["kernels_serve"]}
    assert ("paged_attn_decode", "gqa_stress") in timed
    assert ("absmax_dequant_rows", "serve_decode_read") in timed
    assert {("absmax_quant_rows", "write_serve_decode"),
            ("absmax_quant_rows", "write_serve_prefill"),
            ("absmax_quant_rows", "large")} <= timed
    assert all("sdpa_dense_ms" in t and "sdpa_dense_b2b_ms" in t and t["cluster"] in (1, 2, 4, 8)
               for t in report["kernels_serve"] if t["kernel"] == "paged_attn_decode")
    assert all(t["b2b_ms"] == t["plain_b2b_ms"] == t["device_ms"] == 1.0
               for t in report["kernels_serve"])
    assert {"absmax_quant_rows", "absmax_dequant_rows",
            "paged_attn_decode"} <= set(chip_smoke.SOURCES)


def test_serve_paths_launch_what_chip_smoke_expects(monkeypatch):
    """The three serve paths on a tiny GQA LM: exact launch counts from the
    ServeReport, every stream's length, and the kernel-vs-plain stream
    comparison (plain against plain here: identical)."""
    _serve_on_cpu(monkeypatch)
    monkeypatch.setattr(configs, "get_arch",
                        lambda name: type("Arch", (), {"model": TINY_GQA}))
    monkeypatch.setattr(chip_smoke, "SERVE_SPEC", "12:5,5:3,9:4,3:2,7:6")
    monkeypatch.setattr(chip_smoke, "SERVE_SLOTS", 3)
    monkeypatch.setattr(chip_smoke, "SERVE_PAGE", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_CHUNK", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    report = {}
    launches = chip_smoke.run_serve_paths(report)
    kernels.reset_launch_counts()
    assert set(launches) == set(chip_smoke.SERVE_PATHS)
    runs = report["serve_paths"]
    assert launches["serve_continuous"]["paged_attn_decode"] == \
        2 * runs["serve_continuous"]["decode_steps"] > 0
    q8 = runs["serve_continuous_q8"]
    assert launches["serve_continuous_q8"]["absmax_quant_rows"] == \
        2 * (q8["prefill_chunks"] + q8["decode_steps"])  # 2 layers, k and v in one write
    assert not any(launches["serve_static"].values())
    assert runs["serve_continuous"]["diverged"] == [] == q8["diverged"]


def test_serve_small_input_phase_runs(monkeypatch):
    """Prefix sharing and preemption runs on the reduced GQA LM split pages,
    preempt and give identical streams (kernels and plain versions are both
    plain here; the launches and the pool audit are what is checked)."""
    _serve_on_cpu(monkeypatch)
    report = {}
    chip_smoke.check_serve_small_input(report)
    kernels.reset_launch_counts()
    out = report["small_input_serve"]
    assert set(out) == {f"{k}_{q}" for k in chip_smoke.SERVE_SMALL for q in ("f32", "q8")}
    assert out["share_prefix_f32"]["shared_tokens"] > 0
    assert out["preempt_q8"]["swapped_pages"] > 0


def test_compare_streams_accepts_only_near_ties():
    """A kernel stream may leave the plain one only at a token whose plain
    top-2 margin was below SERVE_TIE_MARGIN; int8 streams (no margins) must
    be identical."""
    want = [[1, 2, 3], [4, 5, 6]]
    assert chip_smoke.compare_streams("x", [[1, 2, 3], [4, 5, 6]], want, None) == []
    got = [[1, 2, 3], [4, 9, 9]]
    tie = {0: [1.0] * 3, 1: [1.0, 0.5 * chip_smoke.SERVE_TIE_MARGIN, 1.0]}
    assert chip_smoke.compare_streams("x", got, want, tie) == [
        {"rid": 1, "token": 1, "margin": 0.5 * chip_smoke.SERVE_TIE_MARGIN}]
    wide = {0: [1.0] * 3, 1: [1.0, 2 * chip_smoke.SERVE_TIE_MARGIN, 1.0]}
    for margins in (wide, None):
        try:
            chip_smoke.compare_streams("x", got, want, margins)
        except chip_smoke.SmokeFailure:
            continue
        raise AssertionError("a divergence past a clear margin was accepted")


def test_wire_kernel_phase_runs_at_a_tiny_width(monkeypatch):
    """The flat-wire kernel phase: full-width shapes cut to 3 blocks, the
    edge inputs, bounds and table rows, with a host clock in place of the
    CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    report = {}
    rows = chip_smoke.check_wire_kernels(3, "cpu", report)
    assert set(rows) == {"randk_gather", "randk_seeded", "block_sumsq", "qsgd_quantize",
                         "qsgd_dequantize"}
    for row in rows.values():
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
        assert row["max_abs_err"] == 0.0
    assert rows["randk_gather"]["bytes"] == 3 * chip_smoke.KB * 12
    assert rows["block_sumsq"]["library_ms"] == 1.0
    assert rows["randk_seeded"]["library_ms"] is None
    timed = {(t["kernel"], t["x"]) for t in report["kernels_wire"]}
    assert len(timed) == 9  # the dequantize reads int8 levels: timed once
    assert set(chip_smoke.SOURCES) == set(kernels.KERNELS)


def test_gather_floor_phase_runs_at_a_tiny_width(monkeypatch):
    """The random-gather yardsticks: both against their plain versions at
    row 1's, the wire's and row 12's shapes cut to 3 blocks, the sweep, and
    the yardsticks' times written into the four gathers' table rows beside
    their sector floors, with a host clock in place of the CUDA events. Of
    these only the measured time goes on the kernel line; the computed
    sector floors stay in the report."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    names = ("randk_seeded_workers", "randk_gather", "randk_seeded", "permk_seeded_workers")
    rows = {name: {"b2b_ms": 2.0, "bound_ms": 0.5} for name in names}
    rows["randk_gather"]["sector_floor_ms"] = rows["randk_seeded"]["sector_floor_ms"] = 0.25
    report = {}
    chip_smoke.check_gather_floors(3, "cpu", report, rows)
    assert set(report["gather_floors"]) == {"randk_seeded_workers", "wire",
                                            "permk_seeded_workers"}
    assert all(rows[name]["gather_floor_ms"] == 1.0 for name in names)
    assert "gather_floor_ms" in chip_smoke.TABLE_EXTRA
    assert not {"sector_floor_ms", "segment_floor_ms"} & set(chip_smoke.TABLE_EXTRA)
    assert rows["randk_gather"]["sector_floor_ms"] == 0.25  # the wire phase's, kept
    assert report["gather_floors"]["wire"]["sector_floor_ms"] == 0.25
    assert all("sector_floor_ms" in f and "segment_floor_ms" in f
               for f in report["gather_floors"].values())
    # row 12 at n = 4: every (w, b) row's 256 affine slots, 4 KiB of 32-byte
    # sectors at most, 8 bytes written a slot
    per_row = rows["permk_seeded_workers"]["sector_floor_ms"] * chip_smoke.HBM_BYTES_PER_S / 1e3
    assert 4 * 3 * 256 * 8 < per_row <= 4 * 3 * (4096 + 256 * 8)
    sweep = report["gather_floors"]["wire"]["sweep_b2b_ms"]
    assert len(sweep) == 6


def test_wire_path_launches_what_chip_smoke_expects(monkeypatch):
    """The wire phase on a reduced LM: exactly ``WIRE_LAUNCHES``, the seeded
    payloads, gathers, levels, nonzeros and wire bits as the card run checks
    them, and the plain run identical."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(configs, "get_arch",
                        lambda name: type("Arch", (), {"model": TINY}))
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    _count_plain_launches(monkeypatch)
    report = {}
    launches = chip_smoke.run_wire_path(report)  # raises SmokeFailure on a drift
    kernels.reset_launch_counts()
    assert {k: v for k, v in launches["wire"].items() if v} == chip_smoke.WIRE_LAUNCHES
    assert set(report["wire"]["seconds_per_call"]) == {
        "randk_compress", "randk_decompress_mean", "block_compress", "block_gather",
        "qsgd_compress", "qsgd_decompress"}


def test_resume_phase_runs_as_chip_smoke_expects(monkeypatch, tmp_path):
    """U, A (checkpoint after step 1) and B (resumed at step 2) on the tiny
    LM: every check of the card's run (B bit-equal to U, c_k, the float32
    ledger, each leg's launches), and the checkpoint directory removed."""
    import tempfile

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(configs, "get_arch",
                        lambda name: type("Arch", (), {"model": TINY}))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _count_plain_launches(monkeypatch)
    report = {}
    launches = chip_smoke.run_resume(report)  # raises SmokeFailure on a drift
    kernels.reset_launch_counts()
    split = chip_smoke.RESUME_SPLIT
    want_b = chip_smoke.resume_launches(chip_smoke.RESUME_PATH,
                                        chip_smoke.EXPECTED_C_K[split:])
    assert {k: v for k, v in launches["resume"].items() if v} == want_b
    res = report["resume"]
    assert res["c_k"] == chip_smoke.EXPECTED_C_K[split:]
    assert res["launches"]["U"] == chip_smoke.EXPECTED_LAUNCHES[chip_smoke.RESUME_PATH]
    assert res["file_gb"] > res["state_gb"] > 0
    assert not list(tmp_path.glob("chip_smoke_resume_*"))  # the directory is gone


def test_resume_helpers():
    from repro_torch.core.marina import MarinaState

    c_k, split = chip_smoke.EXPECTED_C_K, chip_smoke.RESUME_SPLIT
    for path in chip_smoke.ROUND_LAUNCHES:  # the phase's path and the carry shape
        assert chip_smoke.resume_launches(path, c_k) == chip_smoke.EXPECTED_LAUNCHES[path]
    assert chip_smoke.resume_launches("marina_randk_recompute", c_k[:split]) == {
        "randk_seeded_workers": 1, "scatter_accum": 1}
    assert chip_smoke.resume_launches("marina_randk_carry", c_k[split:]) == {
        "randk_seeded_workers": 1, "scatter_epilogue": 1, "mean_epilogue": 1}
    # float32 of the first leg (2^24 + 1 is not a float32), then exact adds
    assert chip_smoke.resumed_bits(2.0**24 + 1, [3.0, 0.5]) == 2.0**24 + 3.5

    def state(g, h0=1.0):
        return MarinaState(params={"w": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)},
                           g=g, step=4, h={"w": torch.full((2, 3), h0)})

    a = state(torch.tensor([0.0, 1.0]))
    assert chip_smoke.state_gb(a) == (3 * 4 + 2 * 2 + 2 * 4 + 6 * 4) / 1e9
    assert chip_smoke.states_bit_equal(a, state(torch.tensor([0.0, 1.0])))
    assert not chip_smoke.states_bit_equal(a, state(torch.tensor([-0.0, 1.0])))
    assert not chip_smoke.states_bit_equal(a, state(torch.tensor([0.0, 1.0]), h0=1.0 + 2**-23))
    b = state(torch.tensor([0.0, 1.0]))
    b.step = 5
    assert not chip_smoke.states_bit_equal(a, b)


def _tiny_families(monkeypatch):
    """get_arch → the family's config with every segment kept (full depth)
    at d_model 64, so that ``family_cfg`` cuts it as on the card."""
    from repro_torch.models import reduced

    real = configs.get_arch

    def tiny(name):
        arch = real(name)
        return dataclasses.replace(arch, model=reduced(
            arch.model, layers=arch.model.num_layers, d_model=64))
    monkeypatch.setattr(configs, "get_arch", tiny)


def test_families_phase_runs_at_a_tiny_width(monkeypatch):
    _serve_on_cpu(monkeypatch)
    _tiny_families(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SERVE_SPEC", "12:5,5:3,9:4,3:2,7:6")
    monkeypatch.setattr(chip_smoke, "SERVE_SLOTS", 3)
    monkeypatch.setattr(chip_smoke, "SERVE_PAGE", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_CHUNK", 4)
    monkeypatch.setattr(chip_smoke, "FAMILY_STATIC", {"gemma3-27b": ("22:6,22:6", 2),
                                                      "deepseek-v3-671b": ("9:6,9:6", 2)})
    monkeypatch.setattr(chip_smoke, "FAMILY_PROFILE_LEN", 9)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_kernel_ms", lambda fn, n=5: (fn(), {
        "paged_attn_decode_kernel": 0.5, "sm90_gemm": 2.0, "copy": 0.25})[1])
    report = {}
    launches = chip_smoke.run_families(report)
    kernels.reset_launch_counts()
    assert set(launches) == set(chip_smoke.FAMILY_SERVE_PATHS)
    fam = report["families"]
    assert set(fam) == set(chip_smoke.FAMILY_REPEATS) | {"seconds"}
    scout = fam["llama4-scout-17b-a16e"]
    f32, q8 = scout["llama4_serve_continuous"], scout["llama4_serve_continuous_q8"]
    assert f32["n_layers"] == 4
    assert launches["llama4_serve_continuous"]["paged_attn_decode"] == \
        4 * f32["decode_steps"] > 0
    assert launches["llama4_serve_continuous_q8"]["absmax_quant_rows"] == \
        4 * (q8["prefill_chunks"] + q8["decode_steps"])
    assert f32["diverged"] == [] == q8["diverged"] and f32["moe_dropped_pairs"] >= 0
    assert scout["reduced"] == ["layers 48 -> 4 (segment repeats [48] -> [4])"]
    prof = scout["decode_profile"]
    assert prof["moe_device_ms"] == prof["layers"] == 4
    assert (prof["paged_device_ms"], prof["gemm_device_ms"], prof["other_device_ms"]) == (
        0.5, 2.0, 0.25) and prof["step_device_ms"] == 2.75
    assert prof["expert_bytes_bound_ms"] > 0 and prof["step_host_ms"] > 0
    ds = fam["deepseek-v3-671b"]
    assert ds["reduced"][0] == "layers 61 -> 2 (segment repeats [3, 58] -> [1, 1])"
    assert ds["reduced"][1].startswith("mtp_depth 1 -> 0")
    assert fam["gemma3-27b"]["reduced"] == [
        "layers 62 -> 6 (segment repeats [10, 1] -> [1])"]
    for name in ("gemma3-27b", "deepseek-v3-671b"):
        tf = fam[name]["serve_static"]["teacher_forced"]
        assert tf["steps"] == chip_smoke.FAMILY_TEACHER_STEPS
        assert tf["max_rel_logit_err"] <= chip_smoke.FAMILY_LOGIT_RTOL
    assert fam["deepseek-v3-671b"]["serve_static"]["moe_dropped_pairs"] >= 0
    assert all(fam[n]["seconds"] > 0 and "peak_mem_gb" in fam[n]
               for n in chip_smoke.FAMILY_REPEATS)


def test_families_small_input_runs_as_chip_smoke_expects(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _count_plain_launches(monkeypatch)
    report = {}
    chip_smoke.check_families_small_input(report)
    kernels.reset_launch_counts()
    out = report["small_input_families"]
    assert set(out) == set(chip_smoke.SMALL_FAMILIES)
    assert all(run["launches"] == chip_smoke.EXPECTED_LAUNCHES["marina_randk_carry"]
               for run in out.values())


def test_recurrent_phase_constants():
    """The recurrent phase's shapes, checked without running it: every
    xLSTM forward it makes (the static prefill, the teacher-forced forward
    over the prompt and FAMILY_TEACHER_STEPS tokens, the trainer's
    sequences) takes S ≤ 256 or a multiple of 256, the mLSTM chunk rule;
    recurrentgemma-2b's prompts run past its window, so the rings wrap; the
    training leg (``xc``) launches the carry path's three kernels, two each
    at c_k = 1, 0, 1, 0."""
    from repro_torch.models import ssm

    def chunk_ok(S):
        return S <= ssm.MLSTM_CHUNK or S % ssm.MLSTM_CHUNK == 0

    for name, (spec, batch) in chip_smoke.RECURRENT_STATIC.items():
        pairs = [tuple(map(int, p.split(":"))) for p in spec.split(",")]
        assert len(pairs) % batch == 0 and len({p for p, _ in pairs}) == 1
        prompt = pairs[0][0]
        if name == "xlstm-350m":
            assert chunk_ok(prompt) and chunk_ok(prompt + chip_smoke.FAMILY_TEACHER_STEPS)
        else:
            assert prompt > configs.get_arch(name).model.window == 2048
    xlstm = configs.get_arch(chip_smoke.RECURRENT_TRAIN_ARCH).model
    assert xlstm.num_layers == 24 and chunk_ok(256)  # the trainer's seq_len above 4 layers
    assert {l.mixer for s in xlstm.segments for l in s.period} == {"mlstm", "slstm"}
    assert chip_smoke.EXPECTED_LAUNCHES["marina_randk_carry"] == {
        "randk_seeded_workers": 2, "scatter_epilogue": 2, "mean_epilogue": 2}
    assert chip_smoke.EXPECTED_C_K == [1, 0, 1, 0]
    assert chip_smoke.RECURRENT_STATE_LENS == (256, 4096)
    assert chip_smoke.SMALL_RECURRENT == {"recurrentgemma-2b": 3, "xlstm-350m": 8}
    assert 0 < chip_smoke.SAMPLE_TEMPERATURE and chip_smoke.RECURRENT_BUDGET_S == 120.0


def test_launch_phase_runs_at_a_tiny_width(monkeypatch):
    """The launch phase on the tiny LM: ml (randk, carry) launches
    ``randk_gather`` and ``scatter_accum`` once a leaf a compressed round
    and nothing on its sync round, mp (flat PP) the flat engine's two RandK
    kernels once a compressed round; the plain runs launch nothing and end
    bit-equal; the payloads crossed the group (two all-gathers a leaf a
    compressed ml round, one all-reduce a sync round, the cohort's payload
    rows a compressed mp round); no group is left up."""
    import torch.distributed as dist

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(configs, "get_arch", lambda name: configs.ArchConfig(model=TINY))
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    _count_plain_launches(monkeypatch)
    # the mesh_serve phase runs on the same group: a small workload
    monkeypatch.setattr(chip_smoke, "SERVE_SPEC", "12:5,5:3,9:4,3:2,7:6")
    monkeypatch.setattr(chip_smoke, "SERVE_SLOTS", 2)
    monkeypatch.setattr(chip_smoke, "SERVE_PAGE", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_CHUNK", 4)
    monkeypatch.setattr(chip_smoke, "MESH_DENSE", (2, 8, 3))
    report = {}
    launches = chip_smoke.run_launch(report)
    kernels.reset_launch_counts()
    assert not dist.is_initialized()
    out = report["launch"]
    nleaf, c = out["leaves"], chip_smoke.LAUNCH_COMPRESSED
    assert (out["backend"], out["world"], out["tier"]) == ("gloo", 1, "loopback")
    assert {k: v for k, v in launches["ml"].items() if v} == {
        "randk_gather": c * nleaf, "scatter_accum": c * nleaf}
    assert {k: v for k, v in launches["mp"].items() if v} == {
        "randk_seeded_workers": chip_smoke.LAUNCH_PP_COMPRESSED,
        "scatter_accum": chip_smoke.LAUNCH_PP_COMPRESSED}
    assert out["ml_bit_equal"] and out["mp_bit_equal"]
    assert out["ml_auto"]["collectives"] == {"all_gather": 2 * c * nleaf, "all_reduce": 1}
    assert out["ml_auto"]["up_bits"]["compressed"] == chip_smoke.ml_up_bits(
        init_params_meta())
    # the bytes the collectives carried, ×8 ÷ n, are the booked bits
    assert out["ml_auto"]["wire_up_bits_by_round"][1:] == [
        out["ml_auto"]["up_bits"]["compressed"]] * c
    assert [set(w) for w in out["ml_auto"]["wire_bytes_by_round"]] == (
        [{"all_reduce"}] + [{"all_gather"}] * c)
    # mp: the cohort rows' payloads and seeds cross by all-gather, exactly
    # the booked r·ζ/n (no dense state)
    mp_wire = out["mp_auto"]["wire_bytes_by_round"]
    assert set(mp_wire[0]) == {"all_reduce"}
    assert [set(w) for w in mp_wire[1:]] == [{"all_gather"}] * chip_smoke.LAUNCH_PP_COMPRESSED
    assert [w["all_gather"] * 8.0 / chip_smoke.LAUNCH_N for w in mp_wire[1:]] == [
        out["mp_auto"]["up_bits_compressed"]] * chip_smoke.LAUNCH_PP_COMPRESSED
    assert out["ml_auto"]["ledger"] == out["ml_ref"]["ledger"]
    # mesh_serve: the paged bundles' streams equal run_continuous's (checked
    # in the phase), their launches are the serve paths', the exchanges
    # carried every slot's K/V rows and token each decode step; the dense
    # bundles hold to a teacher-forced forward; the ml round's roofline
    ms = report["mesh_serve"]
    f32, q8 = ms["mesh_serve_f32"], ms["mesh_serve_q8"]
    assert launches["mesh_serve_f32"]["paged_attn_decode"] == f32["decode_steps"] > 0
    assert launches["mesh_serve_q8"]["absmax_quant_rows"] == (
        q8["prefill_chunks"] + q8["decode_steps"])
    assert launches["mesh_serve_q8"]["absmax_dequant_rows"] == 2 * q8["decode_steps"]
    assert f32["wire_bytes"]["tokens"] == f32["decode_steps"] * 2 * 4
    assert f32["plain_diverged"] == [] == q8["plain_diverged"]
    assert 0 < f32["floor_share"] and f32["median_bound_ms"] > 0
    assert ms["dense"]["max_rel_logit_err"] <= chip_smoke.FAMILY_LOGIT_RTOL
    assert len(ms["param_counts"]) == 10
    ml = ms["ml_round"]
    assert ml["model_flops"] == 6.0 * ms["param_counts"]["qwen1.5-0.5b"][1] * 4 * 8 * 256
    assert ml["roofline"]["flops_per_device"] > 0 and ml["roofline"]["bytes_per_device"] > 0
    assert ml["roofline"]["collective_bytes_per_device"] == 0.0  # one rank: no link
    assert "device_busy_ms" not in ml  # no device on the CPU


def init_params_meta():
    from repro_torch.models import init_params

    return init_params(0, TINY, device="meta")


def test_ml_uplink_formula_is_qwen_s():
    """231,993,856 bits a worker a compressed ml round: Σ R·kb·64 over
    Qwen1.5-0.5B's 14 leaves, d = 463,987,712."""
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import init_params, param_count

    shapes = init_params(0, configs.get_arch("qwen1.5-0.5b").model, device="meta")
    assert param_count(shapes) == chip_smoke.QWEN_D
    assert len(tree_leaves(shapes)) == 14
    assert chip_smoke.ml_up_bits(shapes) == chip_smoke.ML_UP_BITS


def test_transport_width_phase_runs_at_a_tiny_row_count(monkeypatch):
    """``scatter_accum`` and ``randk_gather`` at the transport's widths (L =
    2816 and 25,600, R cut to a few rows) against their plain versions, the
    MLP leaf timed against its bound, with a host clock in place of the
    CUDA events."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms", lambda fn, n=25: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    widths = {k: (n, 3, L, kb) for k, (n, _R, L, kb) in chip_smoke.TRANSPORT_WIDTHS.items()}
    assert [w[2] for w in widths.values()] == [2816, 25600]
    monkeypatch.setattr(chip_smoke, "TRANSPORT_WIDTHS", widths)
    rows, report = {"scatter_accum": {}, "randk_gather": {}}, {}
    chip_smoke.check_transport_widths("cpu", report, rows)
    assert set(report["transport_widths"]) == set(widths)
    t = rows["scatter_accum"]["transport"]
    n, R, L, kb = widths["qwen_mlp"]
    assert t["bytes"] == n * R * kb * 8 + R * L * 4 and t["bound_by"] == "bytes"
    assert rows["randk_gather"]["transport"]["shape"] == [n * R, L, kb]
