#!/usr/bin/env python3
"""Time the serving kernels, the QSGD and natural epilogues, the QSGD
dequant-mean and the RandK uplink and scatter-mean from one checkout of the
port.

    python3 scripts/serve_kernels_ab.py --root DIR --label NAME [--parts LIST]

Imports ``repro_torch`` from ``DIR/src`` (a checkout of any commit of the
port; the kernels build into ``DIR/build``) and times, with
``chip_smoke.py``'s single-call median, back-to-back CUDA-event and
profiler device-time timers and its host-clock µs per call, on the same
seeded inputs for every checkout. ``--parts`` (comma-separated, default
all) picks:

* ``paged``: ``paged_attn_decode`` at ``chip_smoke.PAGED_SHAPES``, f32 and bf16;
* ``dequant``: ``absmax_dequant_rows`` at the int8 decode read (73,728 rows
  of 64) and at R = 2^20, W = 128;
* ``write``: the int8 page write of one layer and step, k and v, as the
  checkout's serve path makes it (``models.attention._paged_write`` on an
  int8 pool, backend ``auto``), at ``chip_smoke.PAGE_WRITE_SHAPES``, rows f32;
* ``qsgd``: ``qsgd_epilogue`` at Qwen1.5-0.5B's full width (nblk =
  ceil(d / 1024), B = 1024, s = 7), n = 4 and n = 1, x f32 and bf16;
* ``natural``: ``natural_epilogue`` at the same width, n = 4 and n = 1, x
  f32 and bf16, on codes in [−127, 127] under power-of-two scales;
* ``scatter``: ``scatter_accum`` at the production shape (n = 4, the same
  nblk, B = 1024, kb = 20, offsets uniform in [0, B)), with ``index_add``
  into zeros (alpha 1/n), the one PyTorch call for the same mean, beside it;
* ``dequant_mean``: ``qsgd_dequant_mean`` at the same width (s = 7), n = 4
  and n = 1, levels in [−s, s];
* ``randk_workers``: ``randk_seeded_workers`` at the production shape (n = 4,
  the same nblk, B = 1024, kb = 20), and beside it, where the checkout has
  ``kernels/yardstick.py``, the gather yardstick's time at that shape (the
  fastest over ``yardstick.SWEEP``, back to back);
* ``permk``: ``permk_seeded_workers`` at the production shape (n = 4, the
  same nblk, B = 1024), x f32 and bf16, with offsets; and where the
  checkout's wrapper takes them, with ``offsets=False`` and on a rank's
  rows (``chip_smoke.PERMK_SUBSET`` of the 4 workers) without offsets;
* ``serve``: the int8-page serve path of ``chip_smoke.py`` (full-width
  Qwen1.5-0.5B, ``SERVE_SPEC``, 8 slots, pages of 16, chunks of 128):
  median decode-step ms and tokens/s;
* ``gathers``: the RandK gathers under each L2 fetch granularity. It reads
  back the context's ``cudaLimitMaxL2FetchGranularity`` before anything
  sets it, and what each of 0, 32, 64 and 128 bytes reads back as; then,
  in legs under the default, 32, 32 and the default again (each set and
  read back), times ``randk_seeded_workers`` at the production shape,
  ``randk_gather`` at the wire shape (f32 and bf16, jittered offsets) and
  at the transport's (98,304 rows of 2816, kb 22), ``randk_seeded`` at the
  wire shape, the gather yardstick at all three shapes (its fastest over
  ``yardstick.SWEEP``), ``torch.gather`` at rows 1 and 10's own offsets
  (int64, converted beforehand), the streaming rows 3, 4, 13 and 15 at the
  production shape, and, under the default and 32, one compressed step of
  the ``marina_randk_carry`` main path (host clock). Also the host µs of a
  set and a restore, and rows 1 and 10 timed with the limit set to 32 just
  before each launch and restored just after. The 32- and 64-byte sector
  floors of each gather's offsets are computed once. The limit is set
  through this checkout's ``csrc/randk.cu``, so ``--root`` may name a
  checkout without it.

Prints one JSON line. To compare two commits on one card, run it in turns
in one call: old, new, new, old. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PARTS = ("paged", "dequant", "write", "qsgd", "natural", "scatter", "dequant_mean",
         "randk_workers", "permk", "serve", "gathers")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timings(call) -> dict:
    return {"ms": chip_smoke.median_ms(call, 25), "b2b_ms": chip_smoke.back_to_back_ms(call),
            "device_ms": chip_smoke.device_ms(call)}


def time_paged(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import paged

    for label, (S, H, KV, hd, P, maxp) in chip_smoke.PAGED_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, n_valid = chip_smoke.paged_inputs(dev, gen, S, H, KV, hd, P,
                                                                 maxp, dt)
            res[f"paged_{label}_{str(dt)[6:]}"] = timings(
                lambda: paged.paged_attn_decode(q, kp, vp, tables, n_valid))


def time_dequant(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import quantize

    S, H, KV, hd, P, maxp = chip_smoke.PAGED_SHAPES["serve"]
    for label, (R, W) in {"decode_read": (S * maxp * P * KV, hd), "large": (1 << 20, 128)}.items():
        c = torch.randint(-127, 128, (R, W), generator=gen, device=dev).to(torch.int8)
        sc = torch.rand((R,), generator=gen, device=dev)
        res[f"dequant_{label}"] = timings(lambda: quantize.absmax_dequant_rows(c, sc))


def time_write(res, dev, gen) -> None:
    import torch

    from repro_torch.models import attention

    for label, (T, n_real, KV, W) in chip_smoke.PAGE_WRITE_SHAPES.items():
        k, v, pool, page, row = chip_smoke.page_write_inputs(dev, gen, T, n_real, KV, W,
                                                             torch.float32)

        def call():
            attention._paged_write(pool, k, v, page, row, backend="auto")

        res[f"write_{label}"] = dict(timings(call), host_us=chip_smoke.host_us(call))


def full_width_nblk() -> int:
    """ceil(d / 1024) blocks of Qwen1.5-0.5B's flat parameter vector."""
    from repro_torch.configs import get_arch
    from repro_torch.core import make_layout
    from repro_torch.models import init_params

    shapes = init_params(chip_smoke.SEED, get_arch("qwen1.5-0.5b").model, device="meta")
    return make_layout(shapes, block=chip_smoke.BLOCK).nblk


def time_qsgd(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import epilogue

    nblk, B, s = full_width_nblk(), chip_smoke.BLOCK, 7
    for n in (chip_smoke.N_WORKERS, 1):
        lv = torch.randint(-s, s + 1, (n, nblk, B), generator=gen, device=dev,
                           dtype=torch.int8)
        nm = torch.rand((n, nblk), generator=gen, device=dev)
        g = torch.randn((nblk, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x = torch.randn((nblk, B), generator=gen, device=dev).to(xd)
            res[f"qsgd_epilogue_n{n}_{str(xd)[6:]}"] = timings(
                lambda: epilogue.qsgd_epilogue(lv, nm, g, x, 0.0371, s))
            del x
        del lv, nm, g
        torch.cuda.empty_cache()


def time_natural(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import epilogue, ref

    nblk, B = full_width_nblk(), chip_smoke.BLOCK
    for n in (chip_smoke.N_WORKERS, 1):
        codes = torch.randint(-127, 128, (n, nblk, B), generator=gen, device=dev,
                              dtype=torch.int8)
        scales = ref.pow2_ref(torch.randint(-40, 10, (n, nblk), generator=gen, device=dev))
        g = torch.randn((nblk, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x = torch.randn((nblk, B), generator=gen, device=dev).to(xd)
            res[f"natural_epilogue_n{n}_{str(xd)[6:]}"] = timings(
                lambda: epilogue.natural_epilogue(codes, scales, g, x, 0.0371))
            del x
        del codes, scales, g
        torch.cuda.empty_cache()


def time_scatter(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import randk

    n, nblk, B, kb = chip_smoke.N_WORKERS, full_width_nblk(), chip_smoke.BLOCK, chip_smoke.KB
    v = torch.randn((n, nblk, kb), generator=gen, device=dev)
    o = torch.randint(0, B, (n, nblk, kb), generator=gen, device=dev, dtype=torch.int32)
    flat_idx = (torch.arange(nblk, device=dev)[None, :, None] * B + o.long()).reshape(-1)
    zeros = torch.zeros(nblk * B, device=dev)
    res["scatter_accum"] = timings(lambda: randk.scatter_accum(v, o, B))
    res["scatter_index_add"] = timings(
        lambda: zeros.index_add(0, flat_idx, v.reshape(-1), alpha=1.0 / n))
    del v, o, flat_idx, zeros
    torch.cuda.empty_cache()


def time_dequant_mean(res, dev, gen) -> None:
    import torch

    from repro_torch.kernels import quantize

    nblk, B, s = full_width_nblk(), chip_smoke.BLOCK, 7
    for n in (chip_smoke.N_WORKERS, 1):
        lv = torch.randint(-s, s + 1, (n, nblk, B), generator=gen, device=dev,
                           dtype=torch.int8)
        nm = torch.rand((n, nblk), generator=gen, device=dev)
        res[f"qsgd_dequant_mean_n{n}"] = timings(lambda: quantize.qsgd_dequant_mean(lv, nm, s))
        del lv, nm
        torch.cuda.empty_cache()


def time_randk_workers(res, dev, gen) -> None:
    import importlib.util

    import torch

    from repro_torch.kernels import randk

    n, nblk, B, kb = chip_smoke.N_WORKERS, full_width_nblk(), chip_smoke.BLOCK, chip_smoke.KB
    x3d = torch.randn((n, nblk, B), generator=gen, device=dev)
    seeds = randk.seeds_tensor(chip_smoke.RANDK_SEEDS[:n], dev)
    res["randk_seeded_workers"] = timings(
        lambda: randk.randk_seeded_workers(x3d, seeds, kb, B / kb))
    if importlib.util.find_spec("repro_torch.kernels.yardstick") is not None:
        from repro_torch.kernels import yardstick

        x2d = x3d.view(n * nblk, B)
        res["gather_floor"] = chip_smoke.sweep_floor(
            lambda u, t: lambda: yardstick.gather(x2d, kb, u, t))
    del x3d
    torch.cuda.empty_cache()


def time_permk(res, dev, gen) -> None:
    import inspect

    import torch

    from repro_torch.kernels import permk

    n, nblk, B = chip_smoke.N_WORKERS, full_width_nblk(), chip_smoke.BLOCK
    seed, sub = chip_smoke.PERMK_SEED, chip_smoke.PERMK_SUBSET
    modes = "offsets" in inspect.signature(permk.permk_seeded_workers).parameters
    x32 = torch.randn((n, nblk, B), generator=gen, device=dev)
    for xd in (torch.float32, torch.bfloat16):
        x3d, tag = x32.to(xd), str(xd)[6:]
        res[f"permk_{tag}"] = timings(lambda: permk.permk_seeded_workers(x3d, seed))
        if modes:
            res[f"permk_no_offsets_{tag}"] = timings(
                lambda: permk.permk_seeded_workers(x3d, seed, offsets=False))
            xs = x3d[sub].contiguous()
            res[f"permk_workers_{tag}"] = timings(
                lambda: permk.permk_seeded_workers(xs, seed, workers=sub, n=n, offsets=False))
            del xs
        del x3d
    del x32
    torch.cuda.empty_cache()


def time_serve(res, dev, gen) -> None:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(chip_smoke.SEED, cfg, device=dev)
    reqs = serve.make_workload(cfg, serve.parse_requests(chip_smoke.SERVE_SPEC))
    steps, decode_s = chip_smoke.timed_paged_steps(params, cfg)
    rep = serve.run_continuous(params, cfg, reqs, quantized=True, steps=steps,
                               slots=chip_smoke.SERVE_SLOTS, page_size=chip_smoke.SERVE_PAGE,
                               chunk=chip_smoke.SERVE_CHUNK)
    res["serve_q8"] = {"median_decode_step_ms": statistics.median(decode_s) * 1e3,
                       "tokens_per_s": rep.tokens_per_s, "decode_steps": rep.decode_steps,
                       "prefill_chunks": rep.prefill_chunks}
    del params
    torch.cuda.empty_cache()


def fetch_limit():
    """(read, set) of the context's L2 fetch granularity through this
    checkout's ``csrc/randk.cu`` (its ``kernels/_build.py`` loaded on its
    own, so the timed checkout's ``repro_torch`` is left as it is)."""
    import ctypes
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_ab_build", os.path.join(HERE, "src", "repro_torch", "kernels", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.library("randk")

    def read() -> int:
        out = ctypes.c_int(0)
        build.check(lib.l2_fetch_granularity(ctypes.byref(out)), "l2_fetch_granularity")
        return out.value

    def put(nbytes: int) -> int:
        build.check(lib.set_l2_fetch_granularity(int(nbytes)), "set_l2_fetch_granularity")
        return read()

    return read, put


def time_gathers(res, dev, gen) -> None:
    import torch

    from repro_torch import prng
    from repro_torch.kernels import epilogue, ops, quantize, randk, ref, yardstick

    read, put = fetch_limit()
    default = read()
    res["fetch_default"] = default
    res["fetch_read_back"] = {str(b): put(b) for b in (0, 32, 64, 128)}
    put(default)

    n, nblk, B, kb = chip_smoke.N_WORKERS, full_width_nblk(), chip_smoke.BLOCK, chip_smoke.KB
    x3d = torch.randn((n, nblk, B), generator=gen, device=dev)
    seeds = randk.seeds_tensor(chip_smoke.RANDK_SEEDS[:n], dev)
    scale = B / kb
    _, o1 = randk.randk_seeded_workers(x3d, seeds, kb, scale)
    o1_64 = o1.long()
    key = prng.PRNGKey(chip_smoke.SEED + 6)
    x2d = x3d[0]
    x2b = x2d.to(torch.bfloat16)
    o10 = ops.jittered_offsets(key, nblk, B, kb, device=dev)
    o10_64 = o10.long()
    tn, tR, tL, tkb = chip_smoke.TRANSPORT_WIDTHS["qwen_mlp"]
    xt = torch.randn((tn * tR, tL), generator=gen, device=dev)
    ot = prng.randint(prng.PRNGKey(chip_smoke.SEED + 11), (tn * tR, tkb), 0, tL, device=dev)
    g = torch.randn((nblk, B), generator=gen, device=dev)
    v1 = torch.randn((n, nblk, kb), generator=gen, device=dev)
    wseeds = randk.seeds_tensor([5, 6, 7, 8], dev)
    res["sector_floors"] = {"randk_seeded_workers": chip_smoke.sector_floors(o1, 8),
                            "randk_gather_wire": chip_smoke.sector_floors(o10, 8),
                            "randk_gather_transport": chip_smoke.sector_floors(ot, 8)}
    calls = {
        "randk_seeded_workers": lambda: randk.randk_seeded_workers(x3d, seeds, kb, scale),
        "randk_gather_wire_f32": lambda: randk.randk_gather(x2d, o10, scale),
        "randk_gather_wire_bf16": lambda: randk.randk_gather(x2b, o10, scale),
        "randk_gather_transport": lambda: randk.randk_gather(xt, ot, tL / tkb),
        "randk_seeded_wire": lambda: randk.randk_seeded(x2d, 2**31 + 99, kb, scale),
        "torch_gather_row1": lambda: torch.gather(x3d, 2, o1_64),
        "torch_gather_row10_wire": lambda: torch.gather(x2d, 1, o10_64),
        "scatter_epilogue": lambda: epilogue.scatter_epilogue(v1, o1, g, x2d, 0.0371),
        "mean_epilogue": lambda: epilogue.mean_epilogue(x3d, x2d, 0.0371),
        "qsgd_block_workers": lambda: quantize.qsgd_block_workers(x3d, wseeds, 7),
        "natural_block_workers": lambda: quantize.natural_block_workers(x3d, wseeds),
    }
    for name in ("randk_seeded_workers", "randk_gather_wire_f32"):
        want = calls[name]()
        put(32)
        got = calls[name]()
        put(default)
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        res[f"{name}_same_under_32"] = all(torch.equal(a, b) for a, b in zip(want, got))
    yards = {"row1": (x3d.view(n * nblk, B), kb), "wire": (x2d, kb), "transport": (xt, tkb)}
    legs = []
    for value in (default, 32, 32, default):
        leg = {"asked": value, "read_back": put(value)}
        for name, fn in calls.items():
            leg[name] = {"ms": chip_smoke.median_ms(fn, 25),
                         "b2b_ms": chip_smoke.back_to_back_ms(fn)}
        for label, (xx, k) in yards.items():
            leg[f"yardstick_{label}"] = chip_smoke.sweep_floor(
                lambda u, t, xx=xx, k=k: lambda: yardstick.gather(xx, k, u, t))
        leg["read_after"] = read()
        legs.append(leg)
    put(default)
    res["legs"] = legs

    def around(fn):
        def call():
            put(32)
            out = fn()
            put(default)
            return out
        return call

    res["set_restore_host_us"] = chip_smoke.host_us(lambda: (put(32), put(default)))
    res["set_restore_around"] = {
        name: {"ms": chip_smoke.median_ms(around(calls[name]), 25),
               "b2b_ms": chip_smoke.back_to_back_ms(around(calls[name]))}
        for name in ("randk_seeded_workers", "randk_gather_wire_f32", "randk_gather_transport")}
    del x3d, x2b, xt, ot, g, v1, o1, o1_64, o10, o10_64, calls, yards
    torch.cuda.empty_cache()

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(chip_smoke.SEED, cfg, device=dev)
    steps = {}
    for value in (default, 32):
        put(value)
        _, hist = chip_smoke.train(cfg, params, True, steps=chip_smoke.MAIN_STEPS,
                                   mb_per_worker=chip_smoke.MB_PER_WORKER)
        steps[str(value)] = {"c_k": hist.round_sync, "step_seconds": hist.step_seconds}
        torch.cuda.empty_cache()
    put(default)
    res["mc_steps"] = steps
    del params
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {PARTS}")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch

    if not torch.cuda.is_available():
        print("serve_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 16)
    res = {"label": args.label, "root": args.root, "card": chip_smoke.nvidia_smi_line()}
    timers = {"paged": time_paged, "dequant": time_dequant, "write": time_write,
              "qsgd": time_qsgd, "natural": time_natural, "scatter": time_scatter,
              "dequant_mean": time_dequant_mean, "randk_workers": time_randk_workers,
              "permk": time_permk,
              "serve": time_serve, "gathers": time_gathers}
    for part in PARTS:
        if part in parts:
            timers[part](res, dev, gen)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
