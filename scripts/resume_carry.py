#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s resume phase on the carry shape of MARINA ×
block_randk at full width on one NVIDIA GPU.

    python3 scripts/resume_carry.py

The phase in ``chip_smoke.py`` runs the recompute shape (params and g, a
3.7 GB checkpoint). This runs the same phase (``chip_smoke.run_resume``)
on ``marina_randk_carry``, whose checkpoint adds the four workers' carried
gradients h (11.1 GB): U 4 steps, A 2 steps saving after step 1, B
resuming; B's params, g and h bit-equal to U's, the launches of each leg,
the ledger. Prints the card's name and power limit, the save and load
seconds, and the phase's report as one JSON line. Exits non-zero without a
card or when a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("resume_carry: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    print(chip_smoke.nvidia_smi_line(), flush=True)
    secs, _ = _build.build_all()
    print(f"build: {secs:.2f} s", flush=True)
    report: dict = {}
    t = time.perf_counter()
    chip_smoke.run_resume(report, "marina_randk_carry")
    print(f"resume_carry: {time.perf_counter() - t:.1f} s", flush=True)
    print(json.dumps(report["resume"]))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as exc:
        print(f"resume_carry: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
