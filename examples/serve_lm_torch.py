"""Serving example on the PyTorch port (``examples/serve_lm.py``'s twin):
batched prefill + greedy decode with every cache flavour the port has —
the full KV cache, the sliding-window ring and the MLA latent cache.

Picks a reduced architecture (``--arch``, 2 layers, d_model 128), prefills a
batch of prompts (after a prefix of frontend embeddings for the vision and
audio configs), then decodes greedily, printing throughput. The recurrent
architectures are the next slice of the port and raise
``NotImplementedError``.

Run on the card:  PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3-27b
Run on the CPU:   PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import PUBLIC_TO_MODULE, RECURRENT_IDS, get_arch
from repro_torch.device import default_device
from repro_torch.models import decode_step, init_params, prefill, reduced


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b",
                    choices=sorted(PUBLIC_TO_MODULE) + sorted(RECURRENT_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    arch = get_arch(args.arch)
    cfg = reduced(arch.model, layers=2, d_model=128)
    dev = default_device(args.device)
    params = init_params(0, cfg, device=dev)

    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)), device=dev)
    prefix = (torch.as_tensor(rng.standard_normal((B, 8, cfg.d_model)) * 0.02,
                              dtype=torch.float32, device=dev)
              if arch.prefix_len else None)
    off = 0 if prefix is None else prefix.shape[1]

    print(f"arch={args.arch} (reduced) | batch={B} prompt={P} gen={G} | {dev}")
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompts, prefix, max_len=off + P + G + 8)
        tok = torch.argmax(logits, dim=-1)
        tok.cpu()
        print(f"prefill: {time.perf_counter() - t0:.2f}s ({B * P} tokens)")
        out = [tok]
        t0 = time.perf_counter()
        for i in range(G - 1):
            logits, cache = decode_step(params, cfg, cache, tok, off + P + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        gen = torch.stack(out, dim=1).cpu()
        dt = time.perf_counter() - t0
    print(f"decode: {G - 1} steps × {B} seqs in {dt:.2f}s ({(G - 1) * B / dt:.1f} tok/s)")
    print("sample continuation ids:", gen[0, :12].tolist())
    assert bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
    print("OK")


if __name__ == "__main__":
    main()
