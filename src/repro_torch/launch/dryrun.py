"""The production dry run (port of ``repro.launch.dryrun``): every
(architecture × input shape × mesh) of :func:`combos` run as ONE device's
share of the production program, recording the roofline terms and the
per-device memory.

The reference lowers and compiles each step on 512 fake host devices and
reads XLA's cost and memory analyses. A PyTorch program has no compiled
artifact, so the port runs the step as device 0 of the production mesh
would: :class:`StandInMesh` has the production axes and sizes
(``make_production_mesh``: (16, 16) or (2, 16, 16), laid out for fsdp
where the arch is fsdp: in training where its workers are pods, in serving
on both meshes) and no process group. Its collectives return
tensors of the shapes the live ones return (an all-gather's parts are this
rank's own; a sum is this rank's partial; a broadcast leaves the buffer)
and count kind, op and bytes exactly as the live mesh counts them for
rank 0, which is what ``roofline.collective_stats_from_mesh`` prices. The
step functions of ``build_train_steps``, ``build_serve_steps`` and
``build_paged_serve_steps`` run on it unchanged. Only this module and
``launch/perf.py`` build one; no training or serving path reaches it.

* ``--device meta`` (the default): FLOPs (``FlopCounterMode``), bytes
  (``roofline.ByteCounter``), the device's memory
  (``roofline.memory.MemoryCounter``: XLA's ``memory_analysis`` keys, the
  peak as ``peak_memory_per_device``, the operator at it as
  ``peak_memory_op`` and the bytes live there by allocating operator as
  ``peak_memory_by_op``) and collectives, nothing allocated; the kernels'
  plain versions stand in for the ctypes kernels (counted at what the
  kernels allocate, their outputs), and the one value a step reads on the
  host (the ragged sizes of a column-split leaf's RandK exchange) is
  counted on the CPU from the same key (``transport._cols_counts``).
* ``--device cuda``: the same on the card where the share fits, with
  ``peak_memory_per_device`` the allocator's
  (``torch.cuda.max_memory_allocated``), ``allocated_at_entry`` and the
  counted peak against it (``memory_vs_allocator``); an out-of-memory is
  that step's recorded error, as the reference records a failed
  compile.

Each entry has the reference's keys (``arch``, ``shape``, ``mesh``,
``n_devices``, ``n_workers``, ``params``, ``active_params``, ``steps``,
``wall_s``; each step the roofline report's ``to_dict()`` with
``memory_analysis``, ``ok`` and ``error`` / ``traceback``),
``local_params`` (the parameters device 0 holds),
``arg_bytes_per_device`` (the bytes of the device's inputs: its parameter,
estimator and carry slices, its cache or pool, its batch rows; the
counter's ``argument_size_in_bytes``), ``run_s`` (the step's wall time,
counting modes on) and ``device`` ("meta", or the card's name and power
limit).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # full grid, resumable
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table          # print result table
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback

import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.launch import param_math
from repro_torch.launch.topology import (
    PRODUCTION_SHAPES,
    Mesh,
    num_workers,
    production_topology,
    worker_axis_names,
)
from repro_torch.roofline import analyze_step
from repro_torch.roofline.memory import against_allocator, counted_peak

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


# cheap-to-expensive order so a long grid run banks results early
_ORDER = [
    "qwen1.5-0.5b", "internvl2-1b", "xlstm-350m", "musicgen-medium",
    "recurrentgemma-2b", "gemma3-27b", "qwen3-32b", "deepseek-coder-33b",
    "llama4-scout-17b-a16e", "deepseek-v3-671b",
]


def combos():
    for arch_name in _ORDER:
        arch = get_arch(arch_name)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not arch.runs_long_context:
                continue
            for mesh_name in ("single", "multi"):
                yield arch_name, shape_name, mesh_name


def out_path(arch_name, shape_name, mesh_name, out_dir=None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch_name}__{shape_name}__{mesh_name}.json")


# ---------------------------------------------------------------------------
# the one-device stand-in of a production mesh
# ---------------------------------------------------------------------------


class StandInMesh(Mesh):
    """Device 0 of a production mesh in one process (module doc): worker
    group 0 of ``world``, data index 0 of ``fsdp``, model index 0 of
    ``model``, with no process group. Every collective returns what the
    live one returns in shape and counts what rank 0 counts."""

    def _all_gather(self, outs: list, raw: torch.Tensor, group) -> None:
        for o in outs:
            o.copy_(raw)

    def _broadcast(self, raw: torch.Tensor, src: int, group) -> None:
        pass

    def _all_reduce(self, raw: torch.Tensor, group) -> None:
        pass

    def _all_to_all(self, out: torch.Tensor, raw: torch.Tensor, group) -> None:
        out.copy_(raw)

    def _send(self, raw: torch.Tensor, dst: int, group) -> None:
        pass

    def _recv(self, raw: torch.Tensor, src: int, group) -> None:
        pass

    @property
    def backend(self):
        return None


def stand_in_mesh(arch, multi_pod: bool, device="meta", *, serve: bool = False) -> StandInMesh:
    """The stand-in of ``make_production_mesh(multi_pod=...)`` for ``arch``:
    its workers' groups, the model axis, and the data axis inside a worker
    where the arch is fsdp — in training where its workers are pods, in
    serving (``serve``) on both meshes, as the reference shards an fsdp
    arch's serving parameters over "data" wherever the mesh has it."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    sizes = dict(zip(axes, shape))
    waxes = worker_axis_names(multi_pod, arch.worker_axes)
    fsdp = arch.fsdp and (serve or "data" not in waxes)
    D, m = (sizes["data"] if fsdp else 1), sizes["model"]
    probe = Mesh(axis_names=axes, sizes=shape, device=torch.device(device))
    world = (probe.size // (D * m) if fsdp
             else num_workers(probe, multi_pod, arch.worker_axes))
    return StandInMesh(axis_names=axes, sizes=shape, device=torch.device(device),
                       group="stand-in", rank=0, world=world, model=m, fsdp=D)


def device_label(device) -> str:
    """"meta", or the card's name and power limit as ``nvidia-smi`` gives
    them."""
    if torch.device(device).type != "cuda":
        return str(torch.device(device).type)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else torch.cuda.get_device_name(0)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def _like(shapes, device, dtype=None):
    """Tensors of ``shapes`` (meta tensors) on ``device``: meta stays meta;
    on the card small random values (their bits do not matter, only that
    they are finite)."""
    def one(t):
        out = torch.empty(t.shape, dtype=dtype or t.dtype, device=device)
        return out if out.is_meta else out.normal_(std=0.02)
    return tree_map(one, shapes)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def train_inputs(bundle, arch, spec: dict, device, grad_carry: bool = False) -> tuple:
    """(args, the device's input bytes, the share of each argument the
    device holds; each by step name) of a train bundle on the stand-in:
    this device's parameter and estimator slices (and its carry rows), the
    GLOBAL batch the steps take, of which the device holds its rows."""
    mesh, cfg = bundle.mesh, arch.model
    n = bundle.n_workers
    per_worker = spec["global_batch"] // n
    tok_len = spec["seq_len"] - arch.prefix_len
    dt = next(iter(tree_leaves(bundle.local_shapes))).dtype
    params = _like(bundle.local_shapes, device)
    g = _like(bundle.local_shapes, device)
    rows = len(mesh.workers(n))
    h = (tree_map(lambda t: torch.empty((rows, *t.shape), dtype=t.dtype, device="meta"),
                  bundle.local_shapes) if grad_carry else None)
    if h is not None:
        h = _like(h, device)
    if torch.device(device).type == "meta":
        tokens = torch.empty((n, per_worker, tok_len), dtype=torch.int32, device="meta")
    else:
        tokens = torch.randint(0, cfg.vocab_size, (n, per_worker, tok_len), dtype=torch.int32,
                               device=device)
    batch = {"tokens": tokens}
    if arch.prefix_len:
        batch["prefix"] = _like(torch.empty((n, per_worker, arch.prefix_len, cfg.d_model),
                                            dtype=dt, device="meta"), device)
    # the device's share of the batch: its workers' rows ÷ its data ranks
    share = rows / n / mesh.fsdp
    in_bytes = _bytes(params) + _bytes(g) + _bytes(h) + int(_bytes(batch) * share)
    key = prng.PRNGKey(0)
    state = (params, g) if h is None else (params, g, h)
    args = {"sync_step": (*state, batch), "compressed_step": (*state, batch, key),
            "train_step": (*state, batch, key)}
    shares = {k: (1.0,) * len(state) + (share,) + (1.0,) * (len(a) - len(state) - 1)
              for k, a in args.items()}
    return args, {k: in_bytes for k in args}, shares


def serve_inputs(bundle, arch, spec: dict, device) -> tuple:
    """(args, input bytes, argument shares; each by step name) of a dense
    serve bundle on the stand-in: the parameter slices, the GLOBAL tokens
    (the device holds its rows), the device's cache rows (decode)."""
    from repro_torch.models import init_cache

    mesh, cfg = bundle.mesh, arch.model
    B, S = spec["global_batch"], spec["seq_len"]
    params = _like(bundle.local_shapes, device)
    rows = bundle.meta["rows"]
    meta_dev = torch.device(device).type == "meta"
    if spec["kind"] == "prefill":
        tok_len = S - arch.prefix_len
        tokens = (torch.empty((B, tok_len), dtype=torch.int32, device="meta") if meta_dev
                  else torch.randint(0, cfg.vocab_size, (B, tok_len), dtype=torch.int32,
                                     device=device))
        args = [params, tokens]
        share = len(rows) / B
        in_bytes = _bytes(params) + int(_bytes(tokens) * share)
        if arch.prefix_len:
            pre = _like(torch.empty((B, arch.prefix_len, cfg.d_model),
                                    dtype=next(iter(tree_leaves(params))).dtype,
                                    device="meta"), device)
            args.append(pre)
            in_bytes += int(_bytes(pre) * share)
        return ({"prefill_step": tuple(args)}, {"prefill_step": in_bytes},
                {"prefill_step": (1.0,) + (share,) * (len(args) - 1)})
    dt = next(iter(tree_leaves(params))).dtype
    cache = init_cache(cfg, len(rows), S, dt, device=device, model=mesh.model)
    token = (torch.empty((B,), dtype=torch.int32, device="meta") if meta_dev
             else torch.zeros((B,), dtype=torch.int32, device=device))
    pos = S - 1
    in_bytes = _bytes(params) + _bytes(cache) + int(_bytes(token) * len(rows) / B)
    return ({"decode_step": (params, cache, token, pos)}, {"decode_step": in_bytes},
            {"decode_step": (1.0, 1.0, len(rows) / B, 1.0)})


def step_entry(fn, args, *, in_bytes: int, step_mf: float, topo, mesh, device,
               shares=None) -> dict:
    """One step run on the stand-in under the roofline's counting modes: its
    report (``shares``: the share of each argument the device holds), the
    device's input bytes, the wall time, or the error."""
    entry = {}
    dev = torch.device(device)
    try:
        t1 = time.time()
        rep = analyze_step(fn, *args, n_devices=topo.n_devices, model_flops_total=step_mf,
                           topology=topo, mesh=mesh, arg_shares=shares,
                           device=dev if dev.type == "cuda" else None)
        entry["run_s"] = time.time() - t1
        entry.update(rep.to_dict())
        entry["arg_bytes_per_device"] = float(in_bytes)
        if dev.type == "cuda":
            entry["memory_vs_allocator"] = against_allocator(entry)
        entry["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed step is the entry's record
        entry["ok"] = False
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return entry


def step_flops(mf: float, name: str) -> float:
    """The reference's MODEL_FLOPS per step: compressed rounds re-evaluate
    the old point (2× oracle), sync rounds evaluate once."""
    if name == "train_step":
        return mf
    return mf * (2.0 if name == "compressed_step" else 1.0)


def run_one(arch_name: str, shape_name: str, mesh_name: str, overrides=None,
            device="meta", steps=None) -> dict:
    """One combination on the stand-in (module doc); ``steps`` a subset of
    the bundle's step names to run (all by default)."""
    from repro_torch.launch.distributed import build_serve_steps, build_train_steps

    arch = get_arch(arch_name)
    spec = SHAPES[shape_name]
    multi_pod = mesh_name == "multi"
    mesh = stand_in_mesh(arch, multi_pod, device, serve=spec["kind"] != "train")
    topo = production_topology(multi_pod=multi_pod)
    n_dev = topo.n_devices
    overrides = overrides or {}

    t0 = time.time()
    names = {"train": ("sync_step", "compressed_step", "train_step"),
             "prefill": ("prefill_step",), "decode": ("decode_step",)}[spec["kind"]]
    try:
        if spec["kind"] == "train":
            bundle = build_train_steps(
                arch, mesh, multi_pod,
                global_batch=spec["global_batch"], seq_len=spec["seq_len"],
                topology=topo,   # book wire bits under the MODELED fabric's tiers
                **overrides,
            )
            tokens = spec["global_batch"] * spec["seq_len"]
            args, in_bytes, shares = train_inputs(bundle, arch, spec, device,
                                                  overrides.get("grad_carry", False))
        else:
            bundle = build_serve_steps(
                arch, mesh, batch=spec["global_batch"], seq_len=spec["seq_len"],
                mode=spec["kind"], **overrides,
            )
            tokens = (spec["global_batch"] * spec["seq_len"] if spec["kind"] == "prefill"
                      else spec["global_batch"])
            args, in_bytes, shares = serve_inputs(bundle, arch, spec, device)
    except Exception as e:  # noqa: BLE001 — the reference records a failed build per step
        err = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:], "device": device_label(device)}
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "n_devices": n_dev, "n_workers": None,
                "params": param_math.count_params(arch.model),
                "active_params": param_math.count_active_params(arch.model),
                "local_params": None, "steps": {n: dict(err) for n in names},
                "wall_s": time.time() - t0}
    # forward-only steps do ~2·N·D per token; train ~6·N·D (fwd+bwd)
    mf = param_math.model_flops(arch.model, tokens)
    if spec["kind"] != "train":
        mf /= 3.0

    result = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "n_workers": bundle.n_workers,
        "params": param_math.count_params(arch.model),
        "active_params": param_math.count_active_params(arch.model),
        "local_params": sum(t.numel() for t in tree_leaves(bundle.local_shapes)),
        "steps": {},
    }
    label = device_label(device)
    for name, fn in bundle.fns.items():
        if steps is not None and name not in steps:
            continue
        entry = step_entry(fn, args[name], in_bytes=in_bytes[name],
                           step_mf=step_flops(mf, name), topo=topo, mesh=mesh, device=device,
                           shares=shares[name])
        entry["device"] = label
        result["steps"][name] = entry
    result["wall_s"] = time.time() - t0
    return result


def peak_text(s: dict) -> str:
    """A step entry's counted peak memory and the operator at it, and on
    the card the allocator's beside it."""
    out = ""
    if s.get("memory_analysis") is not None:
        out = (f" peak={counted_peak(s['memory_analysis']) / 1e9:.3f}GB"
               f" at {s.get('peak_memory_op')}")
    cmp = s.get("memory_vs_allocator")
    if cmp is not None:
        out += (f" allocator={cmp['allocator'] / 1e9:.3f}GB"
                f" (gap {cmp['gap'] / 1e9:+.3f}GB)")
    return out


def print_table():
    import glob

    rows = []
    for f in sorted(glob.glob(os.path.join(OUT_DIR, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        for sname, s in r["steps"].items():
            if not s.get("ok"):
                rows.append((r["arch"], r["shape"], r["mesh"], sname, "FAIL", "", "", "", "",
                             ""))
                continue
            peak = s.get("peak_memory_per_device")
            rows.append((
                r["arch"], r["shape"], r["mesh"], sname, s.get("dominant", ""),
                f"{s['compute_s']*1e3:9.2f}",
                f"{s['memory_s']*1e3:9.2f}",
                f"{s['collective_s']*1e3:9.2f}",
                f"{(s.get('useful_ratio') or 0):5.2f}",
                "" if peak is None else f"{peak / 1e9:8.2f}",
            ))
    hdr = ("arch", "shape", "mesh", "step", "dom", "comp_ms", "mem_ms", "coll_ms", "useful",
           "peak_GB")
    print(("{:<24}{:<12}{:<7}{:<17}{:<11}{:>10}{:>10}{:>10}{:>7}{:>9}").format(*hdr))
    for row in rows:
        print("{:<24}{:<12}{:<7}{:<17}{:<11}{:>10}{:>10}{:>10}{:>7}{:>9}".format(*row))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (the default) or cuda (the allocator's peak memory too)")
    ap.add_argument("--out", default=None, help=f"where the JSONs go (default {OUT_DIR})")
    args = ap.parse_args()

    if args.table:
        print_table()
        return

    if args.all:
        todo = list(combos())
    else:
        if not (args.arch and args.shape and args.mesh):
            ap.error("--arch, --shape and --mesh (or --all, or --table)")
        todo = [(args.arch, args.shape, args.mesh)]
    if not args.force:
        for c in [c for c in todo if os.path.exists(out_path(*c, args.out))]:
            print(f"skip {out_path(*c, args.out)}")
            todo.remove(c)
    for arch_name, shape_name, mesh_name in todo:
        path = out_path(arch_name, shape_name, mesh_name, args.out)
        print(f"=== {arch_name} × {shape_name} × {mesh_name} ===", flush=True)
        res = run_one(arch_name, shape_name, mesh_name, device=args.device)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        for sname, s in res["steps"].items():
            status = "ok" if s.get("ok") else "FAIL " + s.get("error", "")[:200]
            extra = ""
            if s.get("ok"):
                extra = (f" dom={s['dominant']} comp={s['compute_s']*1e3:.1f}ms"
                         f" mem={s['memory_s']*1e3:.1f}ms coll={s['collective_s']*1e3:.1f}ms"
                         + peak_text(s))
            print(f"  {sname}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
