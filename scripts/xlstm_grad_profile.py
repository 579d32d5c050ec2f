#!/usr/bin/env python3
"""Time one worker's gradient of xlstm-350m at full width and depth on one
NVIDIA GPU, with and without per-layer remat.

    python3 scripts/xlstm_grad_profile.py

The gradient of ``lm_loss`` on 8 × 256 tokens (one worker's batch in
``chip_smoke.py``'s training leg), f32 random init from seed 0: the host
clock around each of three gradients ending in a synchronize (the first
warms up), then one ``torch.profiler`` trace of a gradient: its device time,
the count of device kernels, and the costliest operators by host and by
device time. The sLSTM layers run a sequential loop over the 256 positions,
so the step is set by host dispatch; remat runs each layer's forward again
in the backward. Prints the card's name and power limit first. Exits
non-zero without a card.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.core.tree_util import tree_flatten, tree_unflatten
    from repro_torch.models import init_params, lm_loss

    if not torch.cuda.is_available():
        print("xlstm_grad_profile: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    cfg = get_arch("xlstm-350m").model
    params = init_params(chip_smoke.SEED, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    toks = torch.randint(0, cfg.vocab_size, (8, 256), device="cuda", generator=gen)
    leaves, treedef = tree_flatten(params)
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        xs = [t.detach().requires_grad_(True) for t in leaves]

        def grad():
            return torch.autograd.grad(lm_loss(tree_unflatten(treedef, xs), c, toks), xs)

        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grad()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            grad()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        print(f"remat {remat}: a gradient {statistics.median(secs[1:]):.3f} s on the host "
              f"clock (runs {[round(s, 3) for s in secs]}), device busy {device_ms:.1f} ms "
              f"in {len(kernels)} kernels", flush=True)
        print(ka.table(sort_by="self_cpu_time_total", row_limit=10, max_name_column_width=40))
        print(ka.table(sort_by="self_device_time_total", row_limit=6, max_name_column_width=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
