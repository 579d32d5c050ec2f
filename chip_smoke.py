#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device — require CUDA; print the card's name and power limit.
2. build — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together); print the seconds.
3. kernels — each of the four main-path kernels against its plain PyTorch
   version on the card, at the production shape of Qwen1.5-0.5B (n = 4
   workers, nblk = ceil(d / 1024), B = 1024, kb = 20) and at a
   forced-duplicates shape (kb = B/2), x in f32 and bf16: offsets and RandK
   values bit-equal, scatter / epilogue outputs within 1 ulp. Median times
   over 20+ launches (CUDA events) for the kernel, its plain version and,
   where one exists, the one PyTorch call that computes the same function.
4. small input — a reduced dense LM trained 4 steps on the card through the
   kernels and through their plain versions (``flat_backend="ref"``), both
   round shapes: the two trajectories agree.
5. main path — Qwen1.5-0.5B at full width, random init from a seed, through
   the port's ``Trainer``: n_workers = 4, batch 8 × 256 tokens per worker,
   block_randk kb = 20, B = 1024; 4 steps with ``carry_grads=False`` and 4
   with ``carry_grads=True``. The launch counts are reset just before each
   of the two paths and read just after it: each path must launch its own
   kernels as many times as its rounds require (recompute: RandK and
   scatter-mean per compressed round; carry: RandK and the scatter epilogue
   per compressed round, the mean epilogue per sync round). The loss is
   finite and the bits ledger equals the wire formula. Median seconds per
   step by round type.
6. profile — one ``torch.profiler`` trace of a compressed step of a
   full-width carry run: its device time split into model forward +
   backward, the port's kernels and the rest, the device's idle share of
   the step, and the costliest device functions.

The output ends with a JSON report of every phase, the kernel table (one
JSON line; ``launches`` sums the two paths, ``launches_by_path`` splits
them), the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
P_SYNC = 0.5
STEPS = 4
#: c_k of steps 0..3 for seed 0, p = 0.5: jax.random.bernoulli on the first
#: half of split(fold_in(PRNGKey(0), step)), computed with JAX on the CPU
EXPECTED_C_K = [1, 0, 1, 0]
KB, BLOCK, N_WORKERS = 20, 1024, 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores

SOURCES = {
    "randk_seeded_workers": ("src/repro_torch/kernels/csrc/randk.cu",
                             "src/repro/kernels/randk.py:209"),
    "scatter_accum": ("src/repro_torch/kernels/csrc/randk.cu",
                      "src/repro/kernels/randk.py:93"),
    "scatter_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                         "src/repro/kernels/epilogue.py:287"),
    "mean_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                      "src/repro/kernels/epilogue.py:109"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a, b) -> int:
    """Largest ulp distance between two f32 / bf16 tensors (bit patterns)."""
    import torch

    if a.dtype == torch.float32:
        ia, ib, top = a.view(torch.int32), b.view(torch.int32), 2**31
    else:
        ia, ib, top = a.view(torch.int16), b.view(torch.int16), 2**15
    ia, ib = ia.long(), ib.long()
    ka = torch.where(ia < 0, -top - ia, ia)
    kb = torch.where(ib < 0, -top - ib, ib)
    return int((ka - kb).abs().max()) if ka.numel() else 0


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call times, each between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(nblk: int, card: str, report: dict) -> dict:
    import torch

    from repro_torch.kernels import epilogue, randk, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for label, (n, nb, B, kb) in {
        "production": (N_WORKERS, nblk, BLOCK, KB),
        "duplicates": (N_WORKERS, 4096, BLOCK, BLOCK // 2),
    }.items():
        timed = label == "production"
        x3d = torch.randn((n, nb, B), generator=gen, device=dev)
        seeds = randk.seeds_tensor([1, 2**31 + 7, 2**32 - 1, 12345][:n], dev)
        scale = B / kb
        v, o = randk.randk_seeded_workers(x3d, seeds, kb, scale)
        vr, orf = ref.randk_seeded_workers_ref(x3d, seeds, kb, scale)
        require(torch.equal(o, orf), f"{label}: randk offsets differ")
        require(torch.equal(v, vr), f"{label}: randk values differ")
        err = {"randk_seeded_workers": 0.0}

        s = randk.scatter_accum(v, o, B)
        sr = ref.scatter_accum_ref(v, o, B)
        require(ulp_diff(s, sr) <= 1, f"{label}: scatter_accum beyond 1 ulp")
        err["scatter_accum"] = float((s - sr).abs().max())
        del s, sr

        g = torch.randn((nb, B), generator=gen, device=dev)
        x32 = torch.randn((nb, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x = x32.to(xd)
            for name, out, want in (
                ("scatter_epilogue", epilogue.scatter_epilogue(v, o, g, x, 0.0371),
                 ref.scatter_epilogue_ref(v, o, g, x, 0.0371)),
                ("mean_epilogue", epilogue.mean_epilogue(x3d, x, 0.0371),
                 ref.mean_epilogue_ref(x3d, x, 0.0371)),
            ):
                require(ulp_diff(out[0], want[0]) <= 1, f"{label}: {name} g' beyond 1 ulp")
                require(ulp_diff(out[1], want[1]) <= 1, f"{label}: {name} x' ({xd}) beyond 1 ulp")
                e = max(float((out[0] - want[0]).abs().max()),
                        float((out[1].float() - want[1].float()).abs().max()))
                err[name] = max(err.get(name, 0.0), e)
                del out, want
        torch.cuda.synchronize()
        report[f"kernels_{label}"] = {"shape": [n, nb, B, kb], "max_abs_err": err}
        print(f"kernels {label} (n={n}, nblk={nb}, B={B}, kb={kb}): match, "
              f"max_abs_err {err}", flush=True)
        if not timed:
            del x3d, v, o, vr, orf, g, x32
            continue

        x = x32
        flat_idx = (torch.arange(nb, device=dev)[None, :, None] * B + o.long()).reshape(-1)
        zeros = torch.zeros(nb * B, device=dev)

        def library_scatter():  # one call: scatter-add into a copy of zeros, ÷ n
            return zeros.index_add(0, flat_idx, v.reshape(-1), alpha=1.0 / n)

        cells = {
            "randk_seeded_workers": (
                lambda: randk.randk_seeded_workers(x3d, seeds, kb, scale),
                lambda: ref.randk_seeded_workers_ref(x3d, seeds, kb, scale), None,
                n * nb * kb * 12 + 4 * n, n * nb * kb),
            "scatter_accum": (
                lambda: randk.scatter_accum(v, o, B),
                lambda: ref.scatter_accum_ref(v, o, B), library_scatter,
                n * nb * kb * 8 + nb * B * 4, n * nb * kb + nb * B),
            "scatter_epilogue": (
                lambda: epilogue.scatter_epilogue(v, o, g, x, 0.0371),
                lambda: ref.scatter_epilogue_ref(v, o, g, x, 0.0371), None,
                n * nb * kb * 8 + 4 * nb * B * 4, n * nb * kb + 4 * nb * B),
            "mean_epilogue": (
                lambda: epilogue.mean_epilogue(x3d, x, 0.0371),
                lambda: ref.mean_epilogue_ref(x3d, x, 0.0371), None,
                (n + 3) * nb * B * 4, (n + 3) * nb * B),
        }
        for name, (kern, plain, lib, nbytes, flops) in cells.items():
            ms = median_ms(kern, 25)
            plain_ms = median_ms(plain, 5)
            lib_ms = median_ms(lib, 25) if lib is not None else None
            b_ms, b_by = bound(nbytes, flops)
            rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err[name], "bytes": nbytes}
            print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_ms} ms, bound {b_ms:.4f} ms ({b_by}) on {card}",
                  flush=True)
        del x3d, v, o, vr, orf, g, x32, x, flat_idx, zeros
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer
# ---------------------------------------------------------------------------


def train(cfg, params, carry: bool, backend: str = "auto", steps: int = STEPS,
          step_hook=None, **kw):
    from repro_torch.train import TrainConfig, Trainer

    tc = TrainConfig(method="marina", compressor="block_randk",
                     comp_kwargs={"kb": KB, "block": BLOCK}, gamma=0.02, p=P_SYNC,
                     n_workers=N_WORKERS, steps=steps, log_every=steps, seed=SEED,
                     carry_grads=carry, flat_backend=backend, **kw)
    return Trainer(cfg, tc, params, device="cuda").run(step_hook)


def check_small_input(report: dict) -> None:
    """The kernels' trajectory against the plain versions' on a small LM."""
    import torch

    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import ModelConfig, dense_stack, init_params

    cfg = ModelConfig(name="tiny-dense", arch_type="dense", d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      segments=dense_stack(2), qkv_bias=True,
                      tie_embeddings=True, rope_theta=1_000_000.0)
    worst = 0.0
    for carry in (False, True):
        params = init_params(SEED, cfg, device="cuda")
        s_k, h_k = train(cfg, params, carry, batch_per_worker=2)
        s_r, h_r = train(cfg, params, carry, "ref", batch_per_worker=2)
        require(h_k.round_sync == h_r.round_sync == EXPECTED_C_K,
                f"small input: c_k {h_k.round_sync} vs {h_r.round_sync}")
        for a, b in zip(tree_leaves(s_k.params), tree_leaves(s_r.params)):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"small input (carry={carry}): kernels and plain versions diverge")
            worst = max(worst, float((a - b).abs().max()))
    report["small_input_max_abs_param_diff"] = worst
    print(f"small input: kernels' and plain versions' trajectories agree "
          f"(max |Δparams| {worst:.3e})", flush=True)


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_step(cfg, params, report: dict) -> None:
    """One ``torch.profiler`` trace of step 1 of a full-width carry run (a
    compressed round; step 0, a sync round, warms the profiler up), read
    back from its Chrome trace: the step's device time split into the
    model's forward + backward (kernels launched inside the trainer's
    ``train.grad`` span), the port's kernels (by name) and everything else
    (pack / unpack, stacking copies, tree ops, the finite guard), and the
    device's idle share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.train.trainer import SPAN_GRAD, SPAN_STEP

    require(EXPECTED_C_K[:2] == [1, 0], "profile: steps 0, 1 must be sync, compressed")
    trace = os.path.join(ROOT, "build", "carry_step_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(trace)) as prof:
        _, hist = train(cfg, params, True, steps=2, step_hook=lambda _: prof.step())
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    trace_mb = os.path.getsize(trace) / 1e6
    os.remove(trace)

    spans = {SPAN_STEP: [], SPAN_GRAD: []}
    launch_ts, device = {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["ts"], e["ts"] + e["dur"], e["name"], args.get("correlation")))
    require(len(spans[SPAN_STEP]) == 1, f"profile: {len(spans[SPAN_STEP])} step spans")
    t0, t1 = spans[SPAN_STEP][0]
    grads = spans[SPAN_GRAD]
    step_dev = [ev for ev in device if t0 <= ev[0] and ev[1] <= t1]
    require(step_dev, "profile: no device activity in the compressed step")

    split = {"model_fwd_bwd": 0.0, "port_kernels": 0.0, "other": 0.0}
    by_name: dict = {}
    for s, e, name, corr in step_dev:
        if any(k in name for k in SOURCES):
            part = "port_kernels"
        elif any(a <= launch_ts.get(corr, -1.0) <= b for a, b in grads):
            part = "model_fwd_bwd"
        else:
            part = "other"
        split[part] += e - s
        key = (part, name[:80])
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    busy = _union_us([(s, e) for s, e, _, _ in step_dev])
    wall = t1 - t0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    report["profile_carry_compressed_step"] = out = {
        "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "device_ms": {k: v / 1e3 for k, v in split.items()},
        "device_events": len(step_dev), "trace_mb": trace_mb,
        "step_seconds": hist.step_seconds,
        "top_device_ms": [[part, name, ms / 1e3] for (part, name), ms in top],
    }
    print(f"profile (carry compressed step, traced): wall {out['wall_ms']:.1f} ms, "
          f"device busy {out['device_busy_ms']:.1f} ms, idle share "
          f"{out['device_idle_share']:.3f}, device ms {out['device_ms']}", flush=True)
    for part, name, ms in out["top_device_ms"]:
        print(f"profile top: {ms:10.3f} ms  {part:14s} {name}", flush=True)
    del prof, events
    torch.cuda.empty_cache()


def run_main_path(report: dict) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import wire
    from repro_torch.models import init_params, param_count

    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device="cuda")
    d = param_count(params)
    nblk = math.ceil(d / BLOCK)
    torch.cuda.reset_peak_memory_stats()
    n_comp, n_sync = EXPECTED_C_K.count(0), EXPECTED_C_K.count(1)
    # what each path must launch: recompute rounds sample and scatter-mean
    # the diffs; carry rounds end in a fused epilogue of either round type
    expected = {
        "recompute": {"randk_seeded_workers": n_comp, "scatter_accum": n_comp,
                      "scatter_epilogue": 0, "mean_epilogue": 0},
        "carry": {"randk_seeded_workers": n_comp, "scatter_accum": 0,
                  "scatter_epilogue": n_comp, "mean_epilogue": n_sync},
    }
    runs, launches = {}, {}
    for carry in (False, True):
        path = "carry" if carry else "recompute"
        kernels.reset_launch_counts()
        state, hist = train(cfg, params, carry)
        launches[path] = kernels.launch_counts()
        require(launches[path] == expected[path],
                f"{path} path launches {launches[path]} != {expected[path]}")
        require(hist.round_sync == EXPECTED_C_K,
                f"carry={carry}: c_k {hist.round_sync} != {EXPECTED_C_K}")
        require(all(math.isfinite(v) for v in hist.loss), f"carry={carry}: loss not finite")
        require(hist.skipped_cum[-1] == 0.0, f"carry={carry}: a round was skipped")
        for c_k, bits in zip(hist.round_sync, hist.round_bits):
            want = wire.dense_f32_bits(d) if c_k else wire.seeded_randk_bits(nblk, KB)
            require(bits == want, f"carry={carry}: ledger {bits} != {want}")
        require(hist.bits_cum[-1] == sum(hist.round_bits), "ledger sum")
        by_type = {}
        for c_k, sec in zip(hist.round_sync, hist.step_seconds):
            by_type.setdefault("sync" if c_k else "compressed", []).append(sec)
        runs[path] = {
            "loss": hist.loss, "c_k": hist.round_sync,
            "step_seconds": hist.step_seconds, "launches": launches[path],
            "median_step_s": {k: statistics.median(v) for k, v in by_type.items()},
        }
        print(f"main path {path}: loss {hist.loss}, c_k {hist.round_sync}, "
              f"launches {launches[path]}, median s/step {runs[path]['median_step_s']}",
              flush=True)
        del state, hist
    report["main_path"] = {"d": d, "nblk": nblk, "runs": runs,
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"main path: d={d}, nblk={nblk}, peak memory "
          f"{report['main_path']['peak_mem_gb']:.2f} GB", flush=True)
    profile_step(cfg, params, report)
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.core import make_layout
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    card = nvidia_smi_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    report: dict = {"card": card}
    secs, logs = _build.build_all()
    report["build_seconds"] = secs
    print(f"build: {secs:.2f} s for {len(logs)} sources", flush=True)
    for name, log in logs.items():  # registers, shared memory, spills
        print("\n".join(f"ptxas {name}: {line.strip()}" for line in log.splitlines()
                        if "Used" in line or "spill" in line), flush=True)

    shapes = init_params(SEED, get_arch("qwen1.5-0.5b").model, device="meta")
    nblk = make_layout(shapes, block=BLOCK).nblk
    rows = check_kernels(nblk, card, report)
    check_small_input(report)
    launches = run_main_path(report)

    table = []
    for name, (source, replaces) in SOURCES.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": sum(by_path.values()),
                      "launches_by_path": by_path,
                      **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms")}})
    print("report: " + json.dumps(report))
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
