#!/usr/bin/env python3
"""Time the two serving kernels, paged attention and the int8 row dequant,
from one checkout of the port.

    python3 scripts/serve_kernels_ab.py --root DIR --label NAME

Imports ``repro_torch`` from ``DIR/src`` (a checkout of any commit of the
port; the kernels build into ``DIR/build``) and times, with
``chip_smoke.py``'s single-call median, back-to-back CUDA-event and
profiler device-time timers, ``paged_attn_decode`` at
``chip_smoke.PAGED_SHAPES`` in f32 and bf16 and
``absmax_dequant_rows`` at the int8 decode read (73,728 rows of 64) and at
R = 2^20, W = 128, on the same seeded inputs as ``chip_smoke.py``. Prints
one JSON line. To compare two commits on one card, run it in turns in one
call: old, new, new, old. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch

    if not torch.cuda.is_available():
        print("serve_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import paged, quantize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 16)
    res = {"label": args.label, "root": args.root, "card": chip_smoke.nvidia_smi_line()}
    for label, (S, H, KV, hd, P, maxp) in chip_smoke.PAGED_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, n_valid = chip_smoke.paged_inputs(dev, gen, S, H, KV, hd, P,
                                                                 maxp, dt)

            def call():
                return paged.paged_attn_decode(q, kp, vp, tables, n_valid)

            res[f"paged_{label}_{str(dt)[6:]}"] = {
                "ms": chip_smoke.median_ms(call, 25), "b2b_ms": chip_smoke.back_to_back_ms(call),
                "device_ms": chip_smoke.device_ms(call)}
    S, H, KV, hd, P, maxp = chip_smoke.PAGED_SHAPES["serve"]
    for label, (R, W) in {"decode_read": (S * maxp * P * KV, hd), "large": (1 << 20, 128)}.items():
        c = torch.randint(-127, 128, (R, W), generator=gen, device=dev).to(torch.int8)
        sc = torch.rand((R,), generator=gen, device=dev)

        def call():
            return quantize.absmax_dequant_rows(c, sc)

        res[f"dequant_{label}"] = {"ms": chip_smoke.median_ms(call, 25),
                                   "b2b_ms": chip_smoke.back_to_back_ms(call),
                                   "device_ms": chip_smoke.device_ms(call)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
