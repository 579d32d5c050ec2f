"""The §Perf variant runner (port of ``repro.launch.perf``): one (arch ×
shape × mesh) of the dry run with one named variant applied, recorded as
``launch/dryrun.py`` records a step — one device's share of the
production program on the dry run's stand-in mesh (its roofline terms and
its counted memory; on the card the allocator's peak beside it), plus the
transport's bits-by-link-tier ledger (``wire_by_tier``).

Every name of the reference's ``VARIANTS`` is kept and mapped to the
port's dials. Three set a GSPMD sharding constraint the port does not have
(it stages each rank's own rows, with no ``staged_payload`` keyword):
``staged_payload`` and ``unstaged_payload`` run as ``baseline`` and
``staged_shared`` as ``shared_mask``, each saying so in a ``note``. The
port's ``replicate_params`` keeps the model axis inside one rank, so that
variant's stand-in holds no model split and computes its worker's whole
batch (a ``note`` too). ``paged_decode`` keeps the reference's pool sizing
(50 % occupancy, pages of 64) and its ``decode_bound`` and
``prefix_sharing`` records. The reference lowers only; timing the
variants is the benchmark's work.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch xlstm-350m \\
      --shape train_4k --mesh single --variant replicate_params [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.tree_util import tree_leaves
from repro_torch.launch import param_math
from repro_torch.launch.dryrun import (
    OUT_DIR,
    SHAPES,
    _like,
    device_label,
    peak_text,
    serve_inputs,
    stand_in_mesh,
    step_entry,
    step_flops,
    train_inputs,
)
from repro_torch.launch.topology import production_topology
from repro_torch.roofline import decode_bandwidth_bound_s, prefill_sharing_savings

PERF_DIR = os.path.join(os.path.dirname(OUT_DIR), "perf_torch")

# variant name -> (builder overrides, model-config replaces, arch replaces)
VARIANTS = {
    "baseline": ({}, {}, {}),
    # compression / collective schedule
    "shared_mask": ({"shared_mask": True}, {}, {}),
    "packed_payload": ({"packed_payload": True}, {}, {}),
    "shared_and_packed": ({"shared_mask": True, "packed_payload": True}, {}, {}),
    # correlated Perm-K: disjoint d/n shards, values-only exchange
    "permk_payload": ({"compression": "permk"}, {}, {}),
    "permk_packed": ({"compression": "permk", "packed_payload": True}, {}, {}),
    # packed quantization wire: int8 levels + f32 norms; 4-bit nibbles
    "qsgd_payload": ({"compression": "qsgd"}, {}, {}),
    "qsgd4_packed": ({"compression": "qsgd", "packed_payload": True, "qsgd_s": 7}, {}, {}),
    # round pipeline
    "grad_carry": ({"grad_carry": True}, {}, {}),
    "downlink_qsgd": ({"downlink": "qsgd", "downlink_s": 7}, {}, {}),
    "carry_down_qsgd": ({"grad_carry": True, "downlink": "qsgd", "downlink_s": 7}, {}, {}),
    # sync-exchange A/B: the packed flat exchange forced on / off
    "flat_sync": ({"flat_sync": True}, {}, {}),
    "tree_sync": ({"flat_sync": False}, {}, {}),
    # memory / compute policy
    "no_remat": ({"remat": False}, {}, {}),
    "f32_params": ({"dtype": torch.float32}, {}, {}),
    # small-model distribution: the model axis as within-worker data parallelism
    "replicate_params": ({"replicate_params": True}, {}, {}),
    # attention chunking
    "chunk_2048": ({}, {"attn_chunk": 2048}, {}),
    "chunk_512": ({}, {"attn_chunk": 512}, {}),
    # MoE capacity
    "cap_1.0": ({}, {}, {"moe_cap": 1.0}),
    # giant models: worker = pod+data (more workers, thinner shards)
    "workers_pod_data": ({}, {}, {"worker_axes": "pod_data"}),
    # serving: unembed only the final position during prefill
    "last_logits": ({"last_logits": True}, {}, {}),
    # serving: paged KV decode — the pool at 50 % mean occupancy
    "paged_decode": ({"paged": True}, {}, {}),
    # the reference's GSPMD staging constraints (no port dial: notes)
    "staged_payload": ({}, {}, {}),
    "unstaged_payload": ({}, {}, {}),
    "staged_shared": ({"shared_mask": True}, {}, {}),
}

#: what a variant runs in the port where that differs from its name
NOTES = {
    "staged_payload": "the reference's staged_payload pins the payload sharding (GSPMD); "
                      "the port stages each rank's own rows always: this runs as baseline",
    "unstaged_payload": "the reference's staged_payload=False drops a GSPMD sharding "
                        "constraint the port does not have: this runs as baseline",
    "staged_shared": "the reference's staged payload under the shared mask (GSPMD); the "
                     "port has no staging dial: this runs as shared_mask",
    "replicate_params": "the port's replicate_params keeps the model axis inside one rank: "
                        "the stand-in holds no model split and computes its worker's whole "
                        "batch (the model-axis devices' rows together)",
}


def _arch(arch_name: str, variant: str):
    _over, model_repl, arch_repl = VARIANTS[variant]
    arch = get_arch(arch_name)
    if model_repl:
        arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, **model_repl))
    if "moe_cap" in arch_repl and arch.model.moe is not None:
        moe = dataclasses.replace(arch.model.moe, capacity_factor=arch_repl["moe_cap"])
        arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, moe=moe))
    if "worker_axes" in arch_repl:
        arch = dataclasses.replace(arch, worker_axes=arch_repl["worker_axes"])
    return arch


def _paged_inputs(bundle, arch, pool: tuple, device) -> dict:
    """The paged decode step's inputs at the pool's 50 % occupancy: every
    slot ``seq_len / 2`` tokens long on its own pages; the prefill chunk's
    one request of one page."""
    npage, page_size, max_pages, n_slots = pool
    cfg = arch.model
    params = _like(bundle.local_shapes, device)
    cache = _like(bundle.meta["cache_shapes"], device)
    live = (npage - 1) // n_slots
    lens = torch.full((n_slots,), live * page_size, dtype=torch.int32)
    tbl = torch.zeros((n_slots, max_pages), dtype=torch.int32)
    tbl[:, :live] = 1 + torch.arange(n_slots * live, dtype=torch.int32).reshape(n_slots, live)
    token = torch.zeros((n_slots,), dtype=torch.int32)
    row = torch.zeros((max_pages,), dtype=torch.int32)
    row[0] = 1
    chunk = torch.zeros((1, page_size), dtype=torch.int32)
    return {"paged_decode_step": (params, cache, token, lens, tbl),
            "paged_prefill_chunk": (params, cache, chunk, 0, row, page_size),
            "_bytes": sum(t.numel() * t.element_size() for t in tree_leaves((params, cache)))}


def run_variant(arch_name, shape_name, mesh_name, variant, device="meta"):
    from repro_torch.launch.distributed import build_serve_steps, build_train_steps

    overrides = dict(VARIANTS[variant][0])
    arch = _arch(arch_name, variant)
    spec = SHAPES[shape_name]
    multi_pod = mesh_name == "multi"
    mesh = stand_in_mesh(arch, multi_pod, device, serve=spec["kind"] != "train")
    if overrides.get("replicate_params"):
        mesh = dataclasses.replace(mesh, model=1)
    topo = production_topology(multi_pod=multi_pod)
    n_dev = topo.n_devices

    paged_pool = None
    if spec["kind"] == "train":
        bundle = build_train_steps(
            arch, mesh, multi_pod,
            global_batch=spec["global_batch"], seq_len=spec["seq_len"],
            topology=topo,   # book wire bits under the MODELED fabric's tiers
            **overrides,
        )
        tokens = spec["global_batch"] * spec["seq_len"]
        mf = param_math.model_flops(arch.model, tokens)
        args, in_bytes, shares = train_inputs(bundle, arch, spec, device,
                                              overrides.get("grad_carry", False))
    elif overrides.get("paged"):
        from repro_torch.launch.serve_steps import build_paged_serve_steps

        if spec["kind"] != "decode":
            raise ValueError("paged_decode variant requires a decode shape")
        n_slots, page_size = spec["global_batch"], 64
        max_pages = -(-spec["seq_len"] // page_size)
        # 50% mean occupancy (+ the reserved null page): the dense cache
        # streams n_slots × max_len KV rows per decode step regardless of
        # how full each slot is; the pool holds half that
        npage = 1 + (n_slots * max_pages) // 2
        bundle = build_paged_serve_steps(
            arch, mesh, n_slots=n_slots, npage=npage,
            page_size=page_size, max_pages=max_pages, chunk=page_size,
        )
        tokens = n_slots
        mf = param_math.model_flops(arch.model, tokens) / 3.0
        paged_pool = (npage, page_size, max_pages, n_slots)
        args = _paged_inputs(bundle, arch, paged_pool, device)
        in_bytes = {k: args["_bytes"] for k in bundle.fns}
        shares = dict.fromkeys(bundle.fns)   # the device holds all of its inputs
    else:
        serve_over = {k: v for k, v in overrides.items() if k in ("dtype", "last_logits")}
        bundle = build_serve_steps(
            arch, mesh, batch=spec["global_batch"], seq_len=spec["seq_len"],
            mode=spec["kind"], **serve_over,
        )
        tokens = (spec["global_batch"] * spec["seq_len"] if spec["kind"] == "prefill"
                  else spec["global_batch"])
        mf = param_math.model_flops(arch.model, tokens) / 3.0
        args, in_bytes, shares = serve_inputs(bundle, arch, spec, device)

    result = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "steps": {},
    }
    if variant in NOTES:
        result["note"] = NOTES[variant]

    kv_bytes = dense_kv_bytes = param_bytes = 0.0
    if paged_pool is not None:
        from repro_torch.models import init_cache, init_paged_cache

        def tree_bytes(shapes):
            return float(sum(t.numel() * t.element_size() for t in tree_leaves(shapes)))

        npage, page_size, max_pages, n_slots = paged_pool
        kv_bytes = tree_bytes(init_paged_cache(arch.model, npage, page_size, torch.bfloat16,
                                               device="meta"))
        dense_kv_bytes = tree_bytes(init_cache(arch.model, n_slots, spec["seq_len"],
                                               torch.bfloat16, device="meta"))
        param_bytes = float(param_math.count_params(arch.model)) * 2.0
    label = device_label(device)
    for name, fn in bundle.fns.items():
        t0 = time.time()
        entry = step_entry(fn, args[name], in_bytes=in_bytes[name],
                           step_mf=step_flops(mf, name), topo=topo, mesh=mesh, device=device,
                           shares=shares[name])
        entry["device"] = label
        if entry.get("ok") and paged_pool is not None and name == "paged_decode_step":
            # analytic streaming floor for the step: the paged pool's live
            # bytes vs the dense cache it replaces, collectives priced on the
            # dominant-by-bytes link tier
            by_tier = entry.get("collective_by_tier_bytes") or {}
            tier = max(by_tier, key=by_tier.get) if by_tier else "ici"
            n_coll = sum(entry["collective_counts"].values())
            coll = entry["collective_bytes_per_device"]
            bound = decode_bandwidth_bound_s(kv_bytes, param_bytes, n_dev, topology=topo,
                                             collective_bytes=coll, n_collectives=n_coll,
                                             tier=tier)
            dense = decode_bandwidth_bound_s(dense_kv_bytes, param_bytes, n_dev,
                                             topology=topo, collective_bytes=coll,
                                             n_collectives=n_coll, tier=tier)
            bound["kv_bytes"] = kv_bytes
            bound["dense_kv_bytes"] = dense_kv_bytes
            bound["dense_bound_s"] = dense["bound_s"]
            entry["decode_bound"] = bound
            # COW prefix-sharing price for the shared-system-prompt regime
            # on this pool: all n_slots residents share one seq_len prompt
            entry["prefix_sharing"] = prefill_sharing_savings(
                tokens_unshared=float(n_slots * spec["seq_len"]),
                tokens_shared=float(spec["seq_len"]),
                flops_per_token=param_math.model_flops(arch.model, 1) / 3.0,
                kv_bytes_per_token=kv_bytes / (npage * page_size),
                n_devices=n_dev,
            )
        entry["wall_s"] = time.time() - t0
        result["steps"][name] = entry
    tr = getattr(bundle, "transport", None)
    if tr is not None and tr.ledger.bits:
        # the bytes-by-link-tier ledger of whatever the loop above ran
        result["wire_by_tier"] = tr.ledger.to_dict()
    return result


def variant_ledger(arch_name, shape_name, mesh_name, variant) -> dict:
    """The transport's bits-by-tier ledger of a train variant's bundle on
    the meta stand-in, booked by its steps without running them — what the
    reference's ``.lower()`` books (``to_dict()`` form)."""
    from repro_torch.launch.distributed import build_train_steps

    spec = SHAPES[shape_name]
    if spec["kind"] != "train":
        raise ValueError("the wire ledger is a training bundle's")
    arch = _arch(arch_name, variant)
    multi_pod = mesh_name == "multi"
    mesh = stand_in_mesh(arch, multi_pod, "meta")
    overrides = dict(VARIANTS[variant][0])
    if overrides.get("replicate_params"):
        mesh = dataclasses.replace(mesh, model=1)
    bundle = build_train_steps(arch, mesh, multi_pod, global_batch=spec["global_batch"],
                               seq_len=spec["seq_len"],
                               topology=production_topology(multi_pod=multi_pod), **overrides)
    for fn in bundle.fns.values():
        fn.book()
    return bundle.transport.ledger.to_dict()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", required=True, choices=["single", "multi"])
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (the default) or cuda (the allocator's peak memory too)")
    ap.add_argument("--out", default=PERF_DIR, help=f"where the JSON goes (default {PERF_DIR})")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.arch}__{args.shape}__{args.mesh}__{args.variant}.json")
    if os.path.exists(path) and not args.force:
        print(f"skip {path}")
        return
    res = run_variant(args.arch, args.shape, args.mesh, args.variant, device=args.device)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    for sname, s in res["steps"].items():
        if s.get("ok"):
            print(f"{sname}: comp={s['compute_s']*1e3:.1f}ms mem={s['memory_s']*1e3:.1f}ms "
                  f"coll={s['collective_s']*1e3:.1f}ms dom={s['dominant']}{peak_text(s)}",
                  flush=True)
        else:
            print(f"{sname}: FAIL {s['error'][:300]}")


if __name__ == "__main__":
    main()
