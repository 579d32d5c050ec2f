"""What the dry run's memory counter (``roofline.memory.MemoryCounter``)
costs a step: one dry-run train step of a combination, run as
``analyze_step`` runs it, under the FLOP and byte counters alone (``off``),
with the memory counter added (``on``), and with the counter confirming
its marked storages after every operator (``every``: what the counter
did before it waited for an allocation that could set a new peak). The
modes run in the order given, on one bundle, so that a comparison holds
within one process on one device.

For each run it prints and (``--json``) writes: the wall time, and with the
counter the operators it saw, the settles, the ``StorageWeakRef.expired``
checks they made, the most storages marked at a settle, the most storages
live, and the peak and the operator at it (equal in ``on`` and ``every``).

Usage:
    PYTHONPATH=src python scripts/memory_counter_cost.py --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single --device cuda \\
        --order off,on,every,every,on,off --json cost.json
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.distributed import build_train_steps
from repro_torch.launch.topology import production_topology
from repro_torch.roofline.analysis import ByteCounter
from repro_torch.roofline.memory import MemoryCounter


class Tallied(MemoryCounter):
    """The counter, tallying its own work."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.tally = {"ops": 0, "settles": 0, "checks": 0, "most_marked": 0, "most_live": 0}

    def _settle(self) -> None:
        t = self.tally
        t["settles"] += 1
        t["checks"] += len(self._marked)
        t["most_marked"] = max(t["most_marked"], len(self._marked))
        t["most_live"] = max(t["most_live"], len(self._live))
        super()._settle()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.tally["ops"] += 1
        return super().__torch_dispatch__(func, types, args, kwargs)


class EveryOp(Tallied):
    """The counter confirming its marked storages at every operator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._marked:
            self._settle()
        return super().__torch_dispatch__(func, types, args, kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(fn, args, shares, mode: str, device: torch.device) -> dict:
    """One step under the roofline's counters, with the memory counter of
    ``mode`` or without it."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    t0 = time.perf_counter()
    mc = {"off": None, "on": Tallied, "every": EveryOp}[mode]
    mc = mc and mc(args, shares)
    with FlopCounterMode(display=False), ByteCounter():
        if mc is None:
            fn(*args)
        else:
            with mc:
                out = fn(*args)
            mc.analysis(out)
            del out
    _sync(device)
    row = {"mode": mode, "seconds": time.perf_counter() - t0}
    if mc is not None:
        row.update(mc.tally, peak=mc.peak, peak_op=mc.peak_op)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", default="sync_step,compressed_step")
    ap.add_argument("--order", default="off,on,every,every,on,off")
    ap.add_argument("--json", default=None, help="write the rows here")
    a = ap.parse_args()

    device = torch.device(a.device)
    arch, spec, multi = get_arch(a.arch), dryrun.SHAPES[a.shape], a.mesh == "multi"
    if spec["kind"] != "train":
        raise SystemExit("the script runs train steps")
    mesh = dryrun.stand_in_mesh(arch, multi, a.device, serve=False)
    bundle = build_train_steps(arch, mesh, multi, global_batch=spec["global_batch"],
                               seq_len=spec["seq_len"],
                               topology=production_topology(multi_pod=multi))
    args, _in_bytes, shares = dryrun.train_inputs(bundle, arch, spec, a.device)
    rows = []
    for step in a.steps.split(","):
        for mode in a.order.split(","):
            row = {"step": step, **run(bundle.fns[step], args[step], shares[step], mode, device)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"combination": f"{a.arch}__{a.shape}__{a.mesh}", "device":
                       dryrun.device_label(a.device), "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
