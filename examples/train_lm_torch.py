"""LM training with VR-MARINA on the PyTorch port (``examples/train_lm.py``'s
twin).

Trains a transformer LM on the synthetic heterogeneous token pipeline with
compressed communication, logging loss vs bits uplinked per worker (the
paper's Fig. 2 axes). The default config is a ~100M-parameter model;
``--smoke`` runs a ~5M-parameter variant for a few dozen steps. With
``--ckpt-dir`` the run saves three checkpoints and, run again on the same
directory, resumes from the latest (state and bit ledgers).

Run on the card:  PYTHONPATH=src python examples/train_lm_torch.py --smoke
Run on the CPU:   PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu
"""

import argparse

from repro_torch.models import ModelConfig, dense_stack, init_params, param_count
from repro_torch.train import TrainConfig, Trainer


def model_100m() -> ModelConfig:
    return ModelConfig(name="lm-100m", arch_type="dense", d_model=768, num_heads=12,
                       num_kv_heads=12, d_ff=3072, vocab_size=32768,
                       segments=dense_stack(12))


def model_smoke() -> ModelConfig:
    return ModelConfig(name="lm-smoke", arch_type="dense", d_model=160, num_heads=4,
                       num_kv_heads=2, d_ff=512, vocab_size=2048,
                       segments=dense_stack(3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--method", default="vr_marina")
    ap.add_argument(
        "--compressor", default="randk",
        help="randk (per-leaf tree path), block_randk (fused flat engine), "
        "permk (correlated Perm-K: disjoint d/n shards), block_qsgd / "
        "block_natural (packed quantization wire, fused dequantize-and-mean)")
    ap.add_argument("--qsgd-s", type=int, default=7,
                    help="quantization levels for block_qsgd (s ≤ 7 ships the "
                    "4-bit nibble wire)")
    ap.add_argument("--k-frac", type=float, default=0.02)
    ap.add_argument("--gamma", type=float, default=0.25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = model_smoke() if args.smoke else model_100m()
    steps = args.steps or (30 if args.smoke else 300)
    # block_randk's budget is kb coords per 1024-block (kb/1024 ≈ k_frac);
    # permk's is fixed by the partition (d/n per worker)
    if args.compressor in ("block_randk", "flat_randk"):
        comp_kwargs = {"kb": max(1, round(args.k_frac * 1024))}
    elif args.compressor in ("permk", "perm_k", "block_natural", "flat_natural",
                             "natural"):
        comp_kwargs = {}
    elif args.compressor in ("block_qsgd", "flat_qsgd"):
        comp_kwargs = {"s": args.qsgd_s}
    else:
        comp_kwargs = {"k": args.k_frac}
    tcfg = TrainConfig(
        method=args.method, compressor=args.compressor, comp_kwargs=comp_kwargs,
        gamma=args.gamma, n_workers=4,
        batch_per_worker=8 if args.smoke else 16,
        mb_per_worker=4 if args.smoke else 8,
        steps=steps, log_every=max(1, steps // 10),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(1, steps // 3) if args.ckpt_dir else 0,
    )

    params = init_params(0, cfg, device=args.device)
    print(f"model={cfg.name} params={param_count(params):,} method={tcfg.method} "
          f"device {params['embed'].device}")
    trainer = Trainer(cfg, tcfg, params, device=args.device)
    print(f"compressor ζ/d ≈ {args.k_frac}, p = {trainer.p:.4f}\n")

    state, hist = trainer.run()
    print(f"\n{'step':>6} {'loss':>8} {'||g||':>10} {'Mbits/worker':>13}")
    for s, l, g, b in zip(hist.step, hist.loss, hist.grad_est_norm, hist.bits_cum):
        print(f"{s:>6} {l:>8.4f} {g:>10.4f} {b/1e6:>13.2f}")

    if hist.step[0] == -1:
        assert hist.loss[-1] < hist.loss[0], "training must reduce loss"
        print("\nOK: loss decreased with compressed communication.")
    else:
        print(f"\nresumed at step {hist.step[0] + 1}; ledgers continue from "
              f"{hist.bits_cum[0] / 1e6:.2f} Mbits/worker.")


if __name__ == "__main__":
    main()
